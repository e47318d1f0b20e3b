"""The port's LM launch path against the reference: one `make_train_step`
step (the loss, its gradients, AdamW with clipping and weight decay), with
and without microbatches, against the reference's jitted step on the host
mesh from the same parameters and tokens; `TokenStream` restore; the
counterpart of tests/test_checkpoint.py's `test_train_loop_resume`; a
checkpoint the reference's `TrainLoop` wrote, resumed by the port's; both
CLIs at --preset smoke --device cpu.

Tolerances (float32): metrics within 1e-5 relative; the parameters after
the step within 1e-5 of their largest entry, the Adam moments within 1e-4
(gradients in another order); restored state bitwise.
"""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import assert_trees_close, config_pair, rel_err, to_torch
from repro.data.synthetic import TokenStream as JStream
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models import model_zoo as jzoo
from repro.optim import adam_init as jadam_init
from repro.runtime.train_loop import LoopConfig as JLoopConfig
from repro.runtime.train_loop import TrainLoop as JTrainLoop
from repro_torch import convert
from repro_torch.configs import ShapeCell, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.launch import serve, steps, train
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model_zoo
from repro_torch.optim import adam_init
from repro_torch.optim.adam import flatten
from repro_torch.runtime import LoopConfig, TrainLoop


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """TrainLoop installs a SIGTERM handler; give the test process its own back."""
    old = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, old)


def model_zoo_ref_init(jcfg):
    return jzoo.build(jcfg).init(jax.random.PRNGKey(0))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"), microbatches=microbatches)
    shape = ShapeCell("t", 32, 4, "train")
    tokens = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(np.int32)
    mesh = jmesh.make_host_mesh()
    with mesh:
        bundle = jsteps.make_train_step(jcfg, shape, mesh, batch=4)
        jp = model_zoo_ref_init(jcfg)
        tp = to_torch(jp)  # before the step, which donates jp
        jopt = jadam_init(jp, jsteps.default_adam(jcfg))
        jp2, jopt2, jm = bundle.jitted()(jp, jopt, {"tokens": jnp.asarray(tokens)})
    tbundle = steps.make_train_step(tcfg, shape, make_host_mesh("cpu"), batch=4)
    topt = adam_init(tp, steps.default_adam(tcfg))
    tp2, topt2, tm = tbundle.fn(tp, topt, {"tokens": torch.as_tensor(tokens)})
    for k in ("loss", "ce", "grad_norm"):
        assert rel_err(tm[k], jm[k]) <= 1e-5, k
    assert int(topt2.step) == int(jopt2.step) == 1
    assert_trees_close(tp2, jp2, 1e-5, "params")
    assert_trees_close(topt2.m, jopt2.m, 1e-4, "m")
    assert_trees_close(topt2.v, jopt2.v, 1e-4, "v")


def test_bundle_arguments_are_meta():
    cfg = get_smoke_config("smollm-360m")
    shape = ShapeCell("t", 16, 2, "train")
    b = steps.make_train_step(cfg, shape, make_host_mesh("cpu"))
    params_a, opt_a, data_a = b.abstract_args
    assert all(t.device.type == "meta" for t in flatten(params_a)[1] + flatten(opt_a.m)[1])
    assert tuple(data_a["tokens"].shape) == (2, 16)
    d = steps.make_step("decode", cfg, shape, make_host_mesh("cpu"), batch=2)
    assert d.abstract_args[1]["seg0"][0].kv.k.device.type == "meta"
    with pytest.raises(ValueError):
        steps.make_step("bogus", cfg, shape, make_host_mesh("cpu"))


def test_token_stream_restores_and_reads_reference_state():
    cfg = get_smoke_config("smollm-360m")
    shape = ShapeCell("t", 16, 2, "train")
    a = TokenStream(cfg, shape, seed=3, device="cpu")
    first = [a.next() for _ in range(3)]
    st = a.checkpoint_state()
    assert st == {"seed": 3, "step": 3}
    b = TokenStream(cfg, shape, device="cpu")
    b.restore_state(st)
    assert torch.equal(b.next()["tokens"], a.next()["tokens"])
    assert torch.equal(a.batch(1)["tokens"], first[1]["tokens"])
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])
    assert int(first[0]["tokens"].max()) < cfg.vocab_size and first[0]["tokens"].dtype == torch.int32
    # the reference's stream state has the same keys: its position restores here
    js = JStream(config_pair(cfg)[0], shape)
    js.next(), js.next()
    c = TokenStream(cfg, shape, device="cpu")
    c.restore_state(js.checkpoint_state())
    assert c.checkpoint_state() == {"seed": 0, "step": 2}


def _loop(cfg, shape, tmp, params, opt, **kw):
    bundle = steps.make_train_step(cfg, shape, make_host_mesh("cpu"), batch=2)
    lc = LoopConfig(ckpt_dir=str(tmp), ckpt_every=2, log_every=0, async_save=False, **kw)
    return TrainLoop(bundle.fn, params, opt, TokenStream(cfg, shape, batch=2, device="cpu"), lc)


def test_train_loop_resume(tmp_path):
    """Interrupt a loop, restart it, confirm it continues from the step and
    data position, with the saved parameters and moments bit for bit."""
    cfg = get_smoke_config("smollm-360m")
    shape = ShapeCell("t", 32, 2, "train")
    params = model_zoo.build(cfg).init(0, device="cpu")
    opt = adam_init(params, steps.default_adam(cfg))
    loop1 = _loop(cfg, shape, tmp_path, params, opt)
    loop1.run(3)
    assert loop1.step == 3
    loop2 = _loop(cfg, shape, tmp_path, params, opt)
    assert loop2.try_resume() and loop2.step == 3
    assert all(torch.equal(a, b) for a, b in zip(flatten(loop2.params)[1],
                                                  flatten(loop1.params)[1]))
    assert all(torch.equal(a, b) for a, b in zip(flatten(loop2.opt_state)[1],
                                                  flatten(loop1.opt_state)[1]))
    loop2.run(5)
    assert loop2.step == 5
    # data stream resumed from saved position, not from scratch
    assert loop2.data.state.step >= 5


def test_reference_train_loop_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's TrainLoop saves 2 steps; the port's loop resumes
    from that checkpoint with the same parameters, moments, step and data
    position, and trains on."""
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"))
    shape = ShapeCell("t", 32, 2, "train")
    mesh = jmesh.make_host_mesh()
    with mesh:
        bundle = jsteps.make_train_step(jcfg, shape, mesh, batch=2)
        jp = model_zoo_ref_init(jcfg)
        jopt = jadam_init(jp, jsteps.default_adam(jcfg))
        jloop = JTrainLoop(bundle.jitted(), jp, jopt, JStream(jcfg, shape, batch=2),
                           JLoopConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0,
                                       async_save=False))
        jloop.run(2)
    params = model_zoo.build(tcfg).init(7, device="cpu")
    loop = _loop(tcfg, shape, tmp_path, params, adam_init(params, steps.default_adam(tcfg)))
    assert loop.try_resume() and loop.step == 2
    assert loop.data.checkpoint_state() == {"seed": 0, "step": 2}
    want = convert.adam_state_from_numpy(np.asarray(jloop.opt_state.step),
                                         jax.tree.map(np.asarray, jloop.opt_state.m),
                                         jax.tree.map(np.asarray, jloop.opt_state.v),
                                         device="cpu")
    got_p, want_p = flatten(loop.params)[1], flatten(to_torch(jloop.params))[1]
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p))
    assert all(torch.equal(a, b) for a, b in zip(flatten(loop.opt_state)[1], flatten(want)[1]))
    loop.run(3)
    assert loop.step == 3 and int(loop.opt_state.step) == 3


def test_bfloat16_reference_parameters_cross(tmp_path):
    """The full-width smollm-360m dtype (bfloat16) crosses `convert` exactly."""
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"), param_dtype="bfloat16",
                             compute_dtype="bfloat16")
    jp = model_zoo_ref_init(jcfg)
    tp = to_torch(jp)
    for t, j in zip(flatten(tp)[1], jax.tree.leaves(jp)):
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
        assert np.array_equal(t.float().numpy(), np.asarray(j, np.float32))


def test_cli_train_and_serve_smoke(tmp_path, capsys):
    final = train.main(["--arch", "gemma3-4b", "--preset", "smoke", "--device", "cpu",
                        "--steps", "3", "--batch", "2", "--seq", "32",
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert np.isfinite(final["loss"]) and final["grad_norm"] > 0
    r = serve.main(["--arch", "smollm-360m", "--preset", "smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "16", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "prefill: 2x16" in out and "decode: 8 tokens" in out and "sample:" in out
    assert r.tokens.shape == (2, 4) and int(r.tokens.max()) < 512
    with pytest.raises(RuntimeError, match="needs 256 devices.*has 1 rank"):
        train.main(["--arch", "smollm-360m", "--device", "cpu", "--mesh", "pod"])
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        make_production_mesh(multi_pod=True, device="cpu")


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "rwkv6-7b", "moonshot-v1-16b-a3b",
                                  "arctic-480b", "whisper-small", "internvl2-2b"])
def test_launchers_train_and_serve_every_family(arch, tmp_path):
    """The launchers admit every family: a few train steps from the token
    stream (frames / patch prefix included) and a greedy serve."""
    final = train.main(["--arch", arch, "--preset", "smoke", "--device", "cpu", "--steps", "2",
                        "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck")])
    assert np.isfinite(final["loss"]) and final["grad_norm"] > 0
    r = serve.serve(arch, "smoke", batch=2, prompt_len=24, new_tokens=3, device="cpu")
    cfg = get_smoke_config(arch)
    assert r.tokens.shape == (2, 3) and int(r.tokens.max()) < cfg.vocab_size
    assert bool(torch.isfinite(r.last_logits[:, :cfg.vocab_size]).all())


class _Counter:
    """A data iterator with the TokenStream checkpoint interface."""

    def __init__(self):
        self.step = 0

    def next(self):
        self.step += 1
        return {"x": torch.tensor(float(self.step))}

    def checkpoint_state(self):
        return {"seed": 0, "step": self.step}

    def restore_state(self, st):
        self.step = st["step"]


def test_train_loop_retries_watches_stragglers_and_stops_on_sigterm(tmp_path, capsys):
    """The loop's fault paths on a stand-in step: a step that raises once is
    retried after re-syncing from the last checkpoint; a step far slower
    than the running median is flagged; SIGTERM ends the run with a final
    checkpoint."""
    import time as _time

    calls = {"n": 0}

    def step_fn(params, opt, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("transient")
        if calls["n"] == 14:
            _time.sleep(0.2)
        return ({"w": params["w"] + batch["x"]}, opt,
                {"loss": params["w"].sum(), "grad_norm": torch.tensor(1.0)})

    params = {"w": torch.zeros(3)}
    opt = adam_init(params, steps.default_adam(get_smoke_config("smollm-360m")))
    lc = LoopConfig(ckpt_dir=str(tmp_path), ckpt_every=2, log_every=0, async_save=False)
    loop = TrainLoop(step_fn, params, opt, _Counter(), lc)
    loop.run(13)
    out = capsys.readouterr().out
    assert "[retry] step 3 failed (RuntimeError: transient)" in out
    assert "[resume] restored step 2" in out
    assert loop.step == 13 and "[straggler]" in out
    loop._on_sigterm()
    loop.run(20)
    assert loop.step == 13 and loop.ckpt.latest_step() == 13


def test_float32_moments_over_bfloat16_parameters_match_reference():
    """state_dtype='float32' over bf16 parameters: float32 zeros, as the
    reference's `_state_like`, and one AdamW update equal to the reference's
    (the update runs in float32, the parameters round back to bf16)."""
    from repro.optim import AdamConfig as JAdamConfig
    from repro.optim import adam_update as jadam_update
    from repro_torch.optim import AdamConfig, adam_update

    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(8, 4)).astype(np.float32), "b": rng.normal(size=16).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    jg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
    kw = dict(lr=3e-4, weight_decay=0.1, clip_norm=1.0, state_dtype="float32")
    jp2, jst, jn = jadam_update(jg, jadam_init(jp, JAdamConfig(**kw)), jp, JAdamConfig(**kw))
    tp = {k: torch.as_tensor(v).bfloat16() for k, v in p.items()}
    tg = {k: torch.as_tensor(v).bfloat16() for k, v in g.items()}
    st = adam_init(tp, AdamConfig(**kw))
    assert all(m.dtype == torch.float32 and not m.any() for m in flatten(st.m)[1])
    tp2, tst, tn = adam_update(tg, st, tp, AdamConfig(**kw))
    assert rel_err(tn, jn) <= 1e-6
    for k in p:
        assert tp2[k].dtype == torch.bfloat16
        assert np.array_equal(tp2[k].float().numpy(), np.asarray(jp2[k], np.float32)), k
        assert rel_err(tst.m[k], jst.m[k]) <= 1e-6 and rel_err(tst.v[k], jst.v[k]) <= 1e-6
