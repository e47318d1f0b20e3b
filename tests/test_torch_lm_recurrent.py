"""The port's recurrent mixers (`repro_torch.models.rglru`, `rwkv6`)
against the reference: the reference's own properties of
`tests/test_recurrent.py` held by the port (RWKV-6's chunked form equals
its step recurrence over a length that is no chunk multiple, the state
carries across calls, RG-LRU's associative scan equals its step
recurrence, the decay lies in (0, 1)), and each of the port's outputs and
states held to the reference's on the same parameters and inputs. The
tolerances are the reference test's: 2e-4 (RWKV-6) and 3e-4 (RG-LRU),
relative and absolute, and 1e-5 / 1e-6 for the conv tail."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import config_pair, to_torch
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrw
from repro_torch.configs import get_smoke_config
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv6 as trw

RWKV_TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's mixers, compiled once per shape (the config is static)
J_RWKV = jax.jit(jrw.timemix_apply_chunked, static_argnums=3)
J_RGLRU = jax.jit(jrg.rglru_apply_train, static_argnums=3)
RGLRU_TOL = dict(rtol=3e-4, atol=3e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _inputs(arch: str, init, B: int, T: int, seed: int):
    """(reference config, port config, reference params, port params, x as
    numpy float32 (B, T, d))."""
    jcfg, tcfg = config_pair(get_smoke_config(arch))
    jp = init(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, to_torch(jp), x


def _rwkv_steps(params, x, cfg):
    st = trw.timemix_state_init(cfg, x.shape[0], torch.float32, "cpu")
    outs = []
    for t in range(x.shape[1]):
        o, st = trw.timemix_apply_decode(params, x[:, t:t + 1], st, cfg)
        outs.append(o)
    return torch.cat(outs, 1), st


@pytest.mark.parametrize("T", [37, 64])
def test_rwkv_chunked_equals_stepwise(T):
    """T = 37 is no chunk multiple: its padded steps are no-ops."""
    jcfg, cfg, jp, params, x = _inputs("rwkv6-7b", jrw.timemix_init, 2, T, 0)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        out_chunk, st_chunk = trw.timemix_apply_chunked(
            params, xt, trw.timemix_state_init(cfg, 2, torch.float32, "cpu"), cfg)
        out_step, st_step = _rwkv_steps(params, xt, cfg)
    _close(out_chunk, out_step, **RWKV_TOL)
    _close(st_chunk.S, st_step.S, **RWKV_TOL)
    _close(st_chunk.x_prev, st_step.x_prev, rtol=0, atol=0)
    jout, jst = J_RWKV(jp, jnp.asarray(x),
                                          jrw.timemix_state_init(jcfg, 2, jnp.float32), jcfg)
    _close(out_chunk, jout, **RWKV_TOL)
    _close(st_chunk.S, jst.S, **RWKV_TOL)


def test_rwkv_state_carries_across_calls():
    """[0:T] in one call == [0:T/2] then [T/2:T] from the carried state."""
    jcfg, cfg, jp, params, x = _inputs("rwkv6-7b", jrw.timemix_init, 2, 64, 1)
    xt = torch.as_tensor(x)
    st = trw.timemix_state_init(cfg, 2, torch.float32, "cpu")
    with torch.no_grad():
        full, st_full = trw.timemix_apply_chunked(params, xt, st, cfg)
        a, st_mid = trw.timemix_apply_chunked(params, xt[:, :32], st, cfg)
        b, st_end = trw.timemix_apply_chunked(params, xt[:, 32:], st_mid, cfg)
    _close(full, torch.cat([a, b], 1), **RWKV_TOL)
    _close(st_full.S, st_end.S, **RWKV_TOL)
    jst = jrw.timemix_state_init(jcfg, 2, jnp.float32)
    _, jmid = J_RWKV(jp, jnp.asarray(x[:, :32]), jst, jcfg)
    jb, jend = J_RWKV(jp, jnp.asarray(x[:, 32:]), jmid, jcfg)
    _close(b, jb, **RWKV_TOL)
    _close(st_end.S, jend.S, **RWKV_TOL)


def test_rwkv_chunked_gradients_match_reference():
    """The chunk loop under checkpointing differentiates as the reference's
    checkpointed scan: input and parameter gradients at 2e-4."""
    jcfg, cfg, jp, params, x = _inputs("rwkv6-7b", jrw.timemix_init, 2, 40, 2)
    w = np.random.default_rng(3).standard_normal((2, 40, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        out, st = jrw.timemix_apply_chunked(p, xx, jrw.timemix_state_init(jcfg, 2, jnp.float32),
                                            jcfg)
        return jnp.sum(out * w) + jnp.sum(st.S)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    out, st = trw.timemix_apply_chunked(leaves, xt, trw.timemix_state_init(cfg, 2, torch.float32,
                                                                           "cpu"), cfg)
    (torch.sum(out * torch.as_tensor(w)) + torch.sum(st.S)).backward()
    scale = float(np.max(np.abs(np.asarray(jgx))))
    _close(xt.grad / scale, np.asarray(jgx) / scale, **RWKV_TOL)
    for k in ("wr", "wk", "wv", "wg", "wo", "mu", "u", "lora_wA"):
        ref = np.asarray(jgp[k])
        scale = max(float(np.max(np.abs(ref))), 1e-30)
        _close(leaves[k].grad / scale, ref / scale, **RWKV_TOL)


def test_rwkv_decay_in_unit_interval():
    jcfg, cfg, jp, params, _ = _inputs("rwkv6-7b", jrw.timemix_init, 1, 1, 3)
    x = np.random.default_rng(4).standard_normal((4, cfg.d_model)).astype(np.float32) * 3
    logw = trw._decays(params, torch.as_tensor(x), cfg)
    w = torch.exp(logw)
    assert bool((w > 0).all()) and bool((w < 1).all())
    _close(logw, jrw._decays(jp, jnp.asarray(x), jcfg), rtol=1e-6, atol=0)


def test_rwkv_channel_mix_matches_reference():
    jcfg, cfg = config_pair(get_smoke_config("rwkv6-7b"))
    jp = jrw.chanmix_init(jax.random.PRNGKey(5), jcfg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    out, last = trw.chanmix_apply(to_torch(jp), torch.as_tensor(x), torch.as_tensor(prev), cfg)
    jout, _ = jrw.chanmix_apply(jp, jnp.asarray(x), jnp.asarray(prev), jcfg)
    _close(out, jout, **RWKV_TOL)
    assert torch.equal(last, torch.as_tensor(x[:, -1]))


@pytest.mark.parametrize("T", [23, 64])
def test_rglru_scan_equals_stepwise(T):
    jcfg, cfg, jp, params, x = _inputs("recurrentgemma-2b", jrg.rglru_init, 2, T, 2)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        out_scan, st_scan = trg.rglru_apply_train(
            params, xt, trg.rglru_state_init(cfg, 2, torch.float32, "cpu"), cfg)
        st = trg.rglru_state_init(cfg, 2, torch.float32, "cpu")
        outs = []
        for t in range(T):
            o, st = trg.rglru_apply_decode(params, xt[:, t:t + 1], st, cfg)
            outs.append(o)
    _close(out_scan, torch.cat(outs, 1), **RGLRU_TOL)
    _close(st_scan.h, st.h, **RGLRU_TOL)
    _close(st_scan.conv, st.conv, rtol=1e-5, atol=1e-6)
    jout, jst = J_RGLRU(jp, jnp.asarray(x),
                                      jrg.rglru_state_init(jcfg, 2, jnp.float32), jcfg)
    _close(out_scan, jout, **RGLRU_TOL)
    _close(st_scan.h, jst.h, **RGLRU_TOL)
    _close(st_scan.conv, jst.conv, rtol=1e-5, atol=1e-6)


def test_rglru_state_carries_across_calls():
    """The carried state enters as the scan's pseudo-step: [0:T] in one
    call == two calls, and both == the reference's two calls."""
    jcfg, cfg, jp, params, x = _inputs("recurrentgemma-2b", jrg.rglru_init, 2, 30, 4)
    xt = torch.as_tensor(x)
    st = trg.rglru_state_init(cfg, 2, torch.float32, "cpu")
    with torch.no_grad():
        full, st_full = trg.rglru_apply_train(params, xt, st, cfg)
        a, st_mid = trg.rglru_apply_train(params, xt[:, :13], st, cfg)
        b, st_end = trg.rglru_apply_train(params, xt[:, 13:], st_mid, cfg)
    _close(full, torch.cat([a, b], 1), **RGLRU_TOL)
    _close(st_full.h, st_end.h, **RGLRU_TOL)
    jst = jrg.rglru_state_init(jcfg, 2, jnp.float32)
    _, jmid = J_RGLRU(jp, jnp.asarray(x[:, :13]), jst, jcfg)
    jb, jend = J_RGLRU(jp, jnp.asarray(x[:, 13:]), jmid, jcfg)
    _close(b, jb, **RGLRU_TOL)
    _close(st_end.h, jend.h, **RGLRU_TOL)
