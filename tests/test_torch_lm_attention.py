"""The port's blockwise attention (`repro_torch.models.attention`), the
counterpart of tests/test_attention.py: both layouts, causal / windowed /
bidirectional, GQA grouping and ragged kv against a float64 dense
reference and against the reference's `blockwise_attention` on the same
numpy inputs, at the reference's 2e-5; gradients at 1e-4 against the
dense reference and the reference's; the decode ring cache against a
full recompute (2e-4, the reference's bound); `cache_from_prefill` with a
window against the reference's; head padding exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import config_pair, rel_err
from repro.models import attention as jattn
from repro_torch.configs import ModelConfig
from repro_torch.models import attention as tattn


def dense_reference(q, k, v, qp, kp, window, causal):
    """Attention over the whole sequence at once, in float64."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k = k.double().repeat_interleave(G, dim=2)
    v = v.double().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), k) * hd**-0.5
    ok = kp[:, None, :] >= 0
    if causal:
        ok = ok & (qp[:, :, None] >= kp[:, None, :])
    if window > 0:
        ok = ok & (qp[:, :, None] - kp[:, None, :] < window)
    s = torch.where(ok[:, None], s, -1e30)
    out = torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1), v)
    return out.reshape(B, S, H * hd)


def _qkv(B, S, Skv, H, Kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, Skv, Kv, hd), (B, Skv, Kv, hd))]


def _pos(B, S):
    return np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()


# (S, Skv, H, Kv) x (window, causal): ragged kv only for cross attention
# (non-causal), as the reference uses it; S = 20 pads the last q block
CASES = [(shape, wc) for shape in [(32, 32, 4, 2), (24, 24, 6, 6), (32, 17, 4, 1),
                                   (20, 20, 4, 2)]
         for wc in [(-1, True), (7, True), (-1, False)]
         if shape[0] == shape[1] or not wc[1]]


@pytest.mark.parametrize("mode", ["train", "infer"])
@pytest.mark.parametrize("shape,wc", CASES, ids=str)
def test_blockwise_matches_dense_and_reference(mode, shape, wc):
    (S, Skv, H, Kv), (window, causal) = shape, wc
    B, hd = 2, 8
    q, k, v = _qkv(B, S, Skv, H, Kv, hd)
    qp, kp = _pos(B, S), _pos(B, Skv)
    t = [torch.as_tensor(a) for a in (q, k, v, qp, kp)]
    got = tattn.blockwise_attention(*t, window=window, causal=causal, block_q=8,
                                    block_kv=8, mode=mode)
    want = dense_reference(*t, window, causal)
    ref = jattn.blockwise_attention(*(jnp.asarray(a) for a in (q, k, v, qp, kp)),
                                    window=window, causal=causal, block_q=8, block_kv=8,
                                    mode=mode)
    assert got.shape == (B, S, H * hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bfloat16_blocks_score_in_float32():
    """bf16 q/k/v: the port's scores and accumulator are float32, as the
    reference's preferred_element_type asks: the two agree to bf16's
    output rounding."""
    B, S, H, Kv, hd = 2, 32, 4, 2, 16
    q, k, v = _qkv(B, S, S, H, Kv, hd, seed=3)
    qp = _pos(B, S)
    got = tattn.blockwise_attention(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)),
                                    torch.as_tensor(qp), torch.as_tensor(qp), window=-1,
                                    block_q=8, block_kv=8)
    ref = jattn.blockwise_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                    jnp.asarray(qp), jnp.asarray(qp), window=-1,
                                    block_q=8, block_kv=8)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(ref, np.float32)) <= 2**-7


def test_blockwise_gradients_match_dense_and_reference():
    B, S, H, Kv, hd = 2, 32, 4, 2, 8
    q, k, v = _qkv(B, S, S, H, Kv, hd, seed=3)
    qp = _pos(B, S)
    w = np.cos(np.arange(B * S * H * hd, dtype=np.float32).reshape(B, S, H * hd) * 0.01)
    tq, tk, tv = (torch.as_tensor(a).requires_grad_() for a in (q, k, v))
    tp, tw = torch.as_tensor(qp), torch.as_tensor(w)
    got = torch.autograd.grad((tattn.blockwise_attention(
        tq, tk, tv, tp, tp, window=-1, block_q=8, block_kv=8, mode="train") * tw).sum(),
        (tq, tk, tv))
    want = torch.autograd.grad((dense_reference(tq, tk, tv, tp, tp, -1, True).float()
                                * tw).sum(), (tq, tk, tv))

    def jf(q, k, v):
        return jnp.sum(jattn.blockwise_attention(q, k, v, jnp.asarray(qp), jnp.asarray(qp),
                                                 window=-1, block_q=8, block_kv=8,
                                                 mode="train") * w)

    ref = jax.grad(jf, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, d, r, name in zip(got, want, ref, "qkv"):
        np.testing.assert_allclose(g.numpy(), d.numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def _mini_cfg(window=-1):
    return ModelConfig(
        name="t", family="dense", num_layers=1, d_model=32, num_heads=4,
        num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=128,
        window_pattern=(window,), param_dtype="float32", compute_dtype="float32",
    )


def _attn_params(cfg, seed=0):
    jcfg, _ = config_pair(cfg)
    params = jax.tree.map(np.array, jattn.attn_init(jax.random.PRNGKey(seed), jcfg))
    return params, {k: torch.as_tensor(v) for k, v in params.items()}


@pytest.mark.parametrize("window", [-1, 6])
def test_decode_ring_cache_matches_full_recompute(window):
    """Sequential decode through the (ring) cache == attention over the
    full prefix; and each step's output equals the reference's decode."""
    cfg = _mini_cfg(window)
    jcfg, _ = config_pair(cfg)
    jp, tp = _attn_params(cfg)
    B, T = 2, 12
    xs = np.random.default_rng(1).normal(size=(B, T, cfg.d_model)).astype(np.float32)
    cache = tattn.init_cache(cfg, B, T, window, torch.float32, "cpu")
    jcache = jattn.init_cache(jcfg, B, T, window, jnp.float32)
    assert cache.k.shape[1] == (T if window < 0 else window)
    outs = []
    for t in range(T):
        out, cache = tattn.attn_apply_decode(tp, torch.as_tensor(xs[:, t:t + 1]), t, cache,
                                             cfg, window=window)
        jout, jcache = jattn.attn_apply_decode(jp, jnp.asarray(xs[:, t:t + 1]),
                                               jnp.asarray(t, jnp.int32), jcache, jcfg,
                                               window=window)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=2e-5, atol=2e-5)
        np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
        outs.append(out)
    got = torch.cat(outs, dim=1)
    pos = torch.as_tensor(_pos(B, T))
    want = tattn.attn_apply_train(tp, torch.as_tensor(xs), pos, cfg, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S,slots,window", [(10, 16, -1), (13, 6, 6), (6, 6, 6)])
def test_cache_from_prefill_matches(S, slots, window):
    """A prefill's KV written into a cache of `slots` (ring-indexed by
    absolute position when the prompt is longer than a window's slots)."""
    cfg = _mini_cfg(window)
    jcfg, _ = config_pair(cfg)
    B = 2
    rng = np.random.default_rng(2)
    k, v = (rng.normal(size=(B, S, cfg.num_kv_heads, 8)).astype(np.float32) for _ in "kv")
    pos = _pos(B, S)
    cache = tattn.init_cache(cfg, B, slots, window, torch.float32, "cpu")
    jcache = jattn.init_cache(jcfg, B, slots, window, jnp.float32)
    got = tattn.cache_from_prefill(cache, torch.as_tensor(k), torch.as_tensor(v),
                                   torch.as_tensor(pos), window)
    want = jattn.cache_from_prefill(jcache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                                    window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_head_padding_is_exact():
    """padded_heads > H must not change the result (padded heads are
    sliced off before w_o)."""
    cfg = _mini_cfg()
    _, params = _attn_params(cfg)
    B, T = 2, 16
    xs = torch.as_tensor(np.random.default_rng(0).normal(size=(B, T, cfg.d_model)),
                         dtype=torch.float32)
    positions = torch.as_tensor(_pos(B, T))
    base = tattn.attn_apply_train(params, xs, positions, cfg)
    assert cfg.padded_heads(8) == 8
    def constrain(t, tag):  # off any mesh, with the model axis of 8 the padding is for
        return t

    constrain.tp = 8
    got = tattn.attn_apply_train(params, xs, positions, cfg, constrain=constrain)
    np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=2e-5, atol=2e-5)
    assert list(tattn.head_to_kv_map(cfg, 8)) == list(jattn.head_to_kv_map(
        config_pair(cfg)[0], 8))
