"""The port's LM (`repro_torch.models`) against the reference, for every
architecture's smoke config: the dense decoders (smollm-360m, gemma3-4b
with its sliding windows and remainder segment, minicpm-2b,
internlm2-20b), the MoE decoders (moonshot-v1-16b-a3b, arctic-480b with
its dense residual), RG-LRU (recurrentgemma-2b, both segments) and
RWKV-6 (rwkv6-7b), the encoder-decoder (whisper-small) and the
multimodal prefix (internvl2-2b). The reference's parameters cross
through `convert`, both packages take the same numpy batch, and the
training loss, the MoE aux term and every gradient leaf, the prefill
logits and a decode step's logits are held to the reference's (the MoE
configs' routing choices first, for equality). Then the port's own
decode-after-prefill against its full forward (the reference's bound,
1e-3 max(scale, 1); MoE at capacity_factor 8, as the reference's smoke
test) and against the reference's decode, remat giving the same
gradients, the full configs' parameter shapes on the meta device against
`jax.eval_shape` of the reference's init, with their parameter counts,
and the full configs' hyperparameters.

Tolerances (float32, relative to the reference's largest entry): the
loss and aux 1e-5, each gradient leaf 1e-4, logits 1e-4: float32
products and sums in another order through 2-8 layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (assert_same_routing, assert_trees_close, config_pair, jax_batch,
                        lm_batch, rel_err, to_torch, torch_batch, torch_leaves)
from repro.configs.base import get_config as jget_config
from repro.models import model_zoo as jzoo
from repro_torch.configs import ARCH_IDS, ShapeCell, get_config, get_smoke_config
from repro_torch.models import model_zoo, transformer
from repro_torch.optim.adam import flatten, unflatten

# the full configs' parameter counts (`jax.eval_shape` of the reference's init)
FULL_PARAMETERS = {
    "smollm-360m": 361_821_120,
    "recurrentgemma-2b": 2_894_481_920,
    "rwkv6-7b": 7_534_546_944,
    "moonshot-v1-16b-a3b": 28_057_995_264,
    "arctic-480b": 476_850_275_328,
    "whisper-small": 238_139_904,
    "internvl2-2b": 1_889_634_304,
}


@pytest.fixture(scope="module", params=ARCH_IDS)
def pair(request):
    """(reference model, port model, reference params, port params)."""
    jcfg, tcfg = config_pair(get_smoke_config(request.param))
    jm, tm = jzoo.build(jcfg), model_zoo.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jp, to_torch(jp)


def test_train_loss_and_gradients_match(pair):
    jm, tm, jp, tp = pair
    batch = lm_batch(tm.cfg)
    if tm.cfg.num_experts:
        assert_same_routing(jm, tm, jp, tp, batch)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.train_loss(p, b), has_aux=True))(jp, jax_batch(batch))
    leaves = [t.clone().requires_grad_() for t in torch_leaves(tp)]
    params = unflatten(tp, leaves)
    loss, met = tm.train_loss(params, torch_batch(batch))
    grads = unflatten(tp, torch.autograd.grad(loss, leaves))
    assert rel_err(loss, jloss) <= 1e-5 and rel_err(met["ce"], jmet["ce"]) <= 1e-5
    if tm.cfg.num_experts:
        assert float(jmet["aux"]) > 0 and rel_err(met["aux"], jmet["aux"]) <= 1e-5
    else:
        assert float(met["aux"]) == 0.0
    assert_trees_close(grads, jgrads, 1e-4, tm.cfg.name)


def test_remat_gives_the_same_gradients(pair):
    _, tm, _, tp = pair
    batch = torch_batch(lm_batch(tm.cfg))
    out = []
    for remat in (False, True):
        m = model_zoo.build(dataclasses.replace(tm.cfg, remat=remat))
        leaves = [t.clone().requires_grad_() for t in torch_leaves(tp)]
        loss, _ = m.train_loss(unflatten(tp, leaves), batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def _next_position(cfg, batch) -> int:
    """The decode position after a prompt: the text and any frontend prefix."""
    return batch["tokens"].shape[1] + (cfg.frontend_tokens or 0)


def test_prefill_and_decode_match(pair):
    jm, tm, jp, tp = pair
    batch = lm_batch(tm.cfg, seed=1)
    jlog, jst = jm.prefill(jp, jax_batch(batch))
    with torch.no_grad():
        tlog, tst = tm.prefill(tp, torch_batch(batch))
    assert tlog.shape == (2, tm.cfg.padded_vocab())
    assert rel_err(tlog, jlog) <= 1e-4
    pos = _next_position(tm.cfg, batch)
    nxt = np.asarray(jnp.argmax(jlog, -1), np.int32)[:, None]
    jlog2, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos, jnp.int32), jst)
    with torch.no_grad():
        tlog2, _ = tm.decode_step(tp, torch.as_tensor(nxt), pos, tst)
    assert tlog2.dtype == torch.float32 and bool(torch.isfinite(tlog2).all())
    assert rel_err(tlog2, jlog2) <= 1e-4


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_full_forward(arch):
    """The reference's smoke property on the port's own parameters, then the
    port's decode against the reference's on the same ones."""
    cfg = get_smoke_config(arch)
    if cfg.num_experts:  # capacity dropping differs between batch shapes
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    m = model_zoo.build(cfg)
    params = m.init(1, device="cpu")
    batch = lm_batch(cfg, seed=2)
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    pos = _next_position(cfg, short)
    last = batch["tokens"][:, -1:]
    with torch.no_grad():
        logits_full, _ = m.prefill(params, torch_batch(batch))
        _, states = m.prefill(params, torch_batch(short))
        logits_dec, _ = m.decode_step(params, torch.as_tensor(last), pos, states)
    scale = float(logits_full.abs().max()) + 1e-6
    err = float((logits_full - logits_dec).abs().max())
    assert err < 1e-3 * max(scale, 1.0), (arch, err, scale)
    if cfg.padded_vocab() != cfg.vocab_size:
        assert bool((logits_dec[:, cfg.vocab_size:] < -1e29).all())

    jcfg, _ = config_pair(cfg)
    jm = jzoo.build(jcfg)
    # the port's leaves in the reference's tree: both walk dicts in sorted key order
    jparams = jax.tree.unflatten(jax.tree.structure(jax.eval_shape(jm.init, jax.random.PRNGKey(0))),
                                 [jnp.asarray(t.numpy()) for t in torch_leaves(params)])
    _, jst = jm.prefill(jparams, jax_batch(short))
    jdec, _ = jm.decode_step(jparams, jnp.asarray(last), jnp.asarray(pos, jnp.int32), jst)
    assert rel_err(logits_dec, jdec) <= 1e-4


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b"])
def test_unknown_mixer_is_a_value_error(arch):
    """As in the reference, a mixer outside attn / rglru / rwkv is refused
    with a ValueError, at init and at apply."""
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="mamba"):
        transformer._layer_init(None, cfg, "mamba", "meta")
    x = torch.zeros(1, 4, cfg.d_model)
    params = transformer._layer_init(torch.Generator().manual_seed(0), cfg, "attn", "cpu")
    with pytest.raises(ValueError, match="mamba"):
        transformer._layer_apply(params, x, torch.zeros(1, 4, dtype=torch.int32), cfg,
                                 mixer="mamba", window=-1, mode="train", state=None,
                                 cur_pos=None)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_parameter_shapes_match_reference(arch):
    """The full config's parameter tree on the meta device (nothing
    allocated) has the reference's paths, shapes and dtypes."""
    cfg = get_config(arch)
    params = model_zoo.build(cfg).init(device="meta")
    want = jax.eval_shape(jzoo.build(jget_config(arch)).init, jax.random.PRNGKey(0))
    paths, leaves = flatten(params)
    ref = jax.tree.leaves(want)
    assert len(leaves) == len(ref)
    for path, t, r in zip(paths, leaves, ref):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(r.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype), path
    if arch in FULL_PARAMETERS:
        assert sum(t.numel() for t in leaves) == FULL_PARAMETERS[arch]


def test_full_configs_match_assignment():
    """The port's configs carry the reference's hyperparameters, field for
    field, and the assigned ones."""
    expect = {
        "arctic-480b": (35, 7168, 56, 8, 4864, 32000),
        "moonshot-v1-16b-a3b": (48, 2048, 16, 16, 1408, 163840),
        "whisper-small": (12, 768, 12, 12, 3072, 51865),
        "gemma3-4b": (34, 2560, 8, 4, 10240, 262144),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152),
        "minicpm-2b": (40, 2304, 36, 36, 5760, 122753),
        "internlm2-20b": (48, 6144, 48, 8, 16384, 92544),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000),
        "rwkv6-7b": (32, 4096, 64, 64, 14336, 65536),
        "internvl2-2b": (24, 2048, 16, 8, 8192, 92553),
    }
    assert sorted(expect) == sorted(ARCH_IDS)
    for arch, (L, d, H, kv, f, V) in expect.items():
        cfg = get_config(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jget_config(arch)), arch
        got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
               cfg.d_ff, cfg.vocab_size)
        assert got == (L, d, H, kv, f, V), (arch, got)
    assert get_config("gemma3-4b").window_pattern.count(-1) == 1
    assert get_config("smollm-360m").tie_embeddings
    assert (get_config("smollm-360m").param_dtype, get_config("smollm-360m").compute_dtype) \
        == ("bfloat16", "bfloat16")


def test_input_specs_allocate_nothing():
    cfg = get_config("smollm-360m")
    specs = model_zoo.input_specs(cfg, ShapeCell("t", 2048, 8, "train"))
    assert specs["tokens"].device.type == "meta"
    assert tuple(specs["tokens"].shape) == (8, 2048) and specs["tokens"].dtype == torch.int32
    gen = torch.Generator().manual_seed(0)
    batch = model_zoo.make_batch(gen, get_smoke_config("smollm-360m"),
                                 ShapeCell("t", 16, 2, "train"))
    assert batch["tokens"].shape == (2, 16) and int(batch["tokens"].max()) < 512
