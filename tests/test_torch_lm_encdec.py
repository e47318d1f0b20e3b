"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper-small)
and the multimodal prefix (internvl2-2b) against the reference at their
smoke configs, beyond the train / prefill / decode parity of
`test_torch_lm_models.py`: the bidirectional encoder's output, the decode
state's cross-attention K/V computed once at prefill, several greedy
decode steps in a row, the prefix's place in the loss (only the text
positions are scored), and the frontend stubs' shapes.

Tolerances (float32, relative to the reference's largest entry): 1e-4,
as the LM parity tests."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _lm_parity import config_pair, jax_batch, lm_batch, rel_err, to_torch, torch_batch
from repro.models import encdec as jencdec
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention, encdec, frontends, model_zoo

TOL = 1e-4


def _pair(arch: str):
    jcfg, tcfg = config_pair(get_smoke_config(arch))
    jm, tm = jzoo.build(jcfg), model_zoo.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


def test_encoder_matches_reference():
    jm, tm, jp, tp = _pair("whisper-small")
    batch = lm_batch(tm.cfg, seed=3)
    want = jencdec.encode(jp, jnp.asarray(batch["encoder_frames"]), jm.cfg, mode="infer")
    with torch.no_grad():
        got = encdec.encode(tp, torch.as_tensor(batch["encoder_frames"]), tm.cfg, mode="infer")
        got_train = encdec.encode(tp, torch.as_tensor(batch["encoder_frames"]), tm.cfg)
    assert rel_err(got, want) <= TOL
    assert rel_err(got_train, want) <= TOL  # the two attention layouts agree


def test_greedy_decode_steps_match_reference():
    """Prefill stores each layer's cross K/V once; four greedy steps after it
    read them and advance the self-attention caches in place."""
    jm, tm, jp, tp = _pair("whisper-small")
    batch = lm_batch(tm.cfg, B=2, S=12, seed=4)
    steps = 4
    jlog, jst = jm.prefill(jp, jax_batch(batch), total_slots=12 + steps + 1)
    with torch.no_grad():
        tlog, tst = tm.prefill(tp, torch_batch(batch), total_slots=12 + steps + 1)
    assert isinstance(tst, encdec.DecState)
    assert tuple(tst.cross_k.shape) == (tm.cfg.num_layers, 2, tm.cfg.encoder_frames,
                                        tm.cfg.num_kv_heads, tm.cfg.resolved_head_dim())
    assert rel_err(tst.cross_k, jst.cross_k) <= TOL and rel_err(tst.cross_v, jst.cross_v) <= TOL
    assert torch.equal(tst.enc_pos[0], torch.arange(tm.cfg.encoder_frames, dtype=torch.int32))
    cross = (tst.cross_k.clone(), tst.cross_v.clone())
    tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    for i in range(steps):
        jlog, jst = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(12 + i, jnp.int32), jst)
        with torch.no_grad():
            tlog, tst = tm.decode_step(tp, torch.as_tensor(tok), 12 + i, tst)
        assert rel_err(tlog, jlog) <= TOL, i
        tok = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    assert torch.equal(tst.cross_k, cross[0]) and torch.equal(tst.cross_v, cross[1])
    assert int(tst.self_kv.pos.max()) == 12 + steps - 1


def test_prefix_positions_are_not_scored():
    """The vlm loss scores the text after the prefix only: changing the
    prefix moves it (through attention), and the CE's positions are the
    text's, in both packages."""
    jm, tm, jp, tp = _pair("internvl2-2b")
    batch = lm_batch(tm.cfg, seed=5)
    other = dict(batch, frontend_embeds=batch["frontend_embeds"][::-1].copy())
    losses = []
    for b in (batch, other):
        with torch.no_grad():
            loss, _ = tm.train_loss(tp, torch_batch(b))
        jloss, _ = jm.train_loss(jp, jax_batch(b))
        assert rel_err(loss, jloss) <= 1e-5
        losses.append(float(loss))
    assert losses[0] != losses[1]
    # a prefix-free batch is the text alone: its loss differs again
    with torch.no_grad():
        bare, _ = tm.train_loss(tp, torch_batch({"tokens": batch["tokens"]}))
    assert float(bare) not in losses


def test_frontend_stubs_and_cross_attention_init():
    cfg_a, cfg_v = get_smoke_config("whisper-small"), get_smoke_config("internvl2-2b")
    gen = torch.Generator().manual_seed(0)
    frames = frontends.audio_frames_stub(gen, 3, cfg_a)
    patches = frontends.patch_embeds_stub(gen, 2, cfg_v, dtype=torch.bfloat16)
    assert frames.shape == (3, cfg_a.encoder_frames, cfg_a.d_model) and frames.dtype == torch.float32
    assert patches.shape == (2, cfg_v.frontend_tokens, cfg_v.d_model)
    assert patches.dtype == torch.bfloat16
    assert abs(float(frames.std()) - 1.0) < 0.05
    assert (frontends.WHISPER_FRAMES, frontends.INTERNVIT_TOKENS) == (1500, 256)
    self_p = attention.attn_init(torch.Generator().manual_seed(1), cfg_a, "cpu")
    cross_p = attention.attn_init(torch.Generator().manual_seed(1), cfg_a, "cpu", cross=True)
    assert all(torch.equal(self_p[k], cross_p[k]) for k in ("wq", "wk", "wv", "wo"))
