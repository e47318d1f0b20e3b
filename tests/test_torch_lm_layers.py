"""The port's LM layers (`repro_torch.models.layers`) and LR schedules
(`repro_torch.optim.schedule`) against the reference's on the same numpy
inputs: rmsnorm, RoPE, the MLP (SwiGLU and tanh-GELU), logits with padded
ids masked, the chunked cross-entropy and its gradients, and the three
schedules.

Tolerances: float64 inputs (JAX's x64 is on in these tests) agree within
1e-12 where the function computes in the input dtype; rmsnorm and RoPE
compute in float32 whatever the input, so they agree within 2 float32 ulps
(5e-7 relative); float32 products and sums in another order within 2e-6
relative to the output's largest entry; the cross-entropy takes its logits
in float32 whatever the input dtype, so it holds 2e-6 (loss) and 2e-5
(gradients) in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import config_pair, rel_err
from repro.models import layers as jl
from repro.optim import schedule as jsched
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as tl
from repro_torch.optim import schedule as tsched

RNG = np.random.default_rng(0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rmsnorm_matches(dtype):
    x = RNG.normal(size=(2, 5, 16)).astype(dtype) * 3.0
    scale = RNG.uniform(0.5, 1.5, 16).astype(np.float32)
    want = jl.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = tl.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    assert rel_err(got, want) <= 5e-7


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope_matches(theta):
    x = RNG.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 37, (2, 7)).copy()
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    assert rel_err(tl.rope_freqs(8, theta), jl.rope_freqs(8, theta)) <= 2e-7
    assert rel_err(got, want) <= 5e-6  # angles up to ~222 rad in float32


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mlp_matches(act, dtype):
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"), act=act,
                             param_dtype=dtype, compute_dtype=dtype)
    params = jax.tree.map(np.array, jl.mlp_init(jax.random.PRNGKey(1), jcfg))
    x = RNG.normal(size=(2, 4, jcfg.d_model)).astype(dtype)
    want = jl.mlp_apply(params, jnp.asarray(x), jcfg)
    got = tl.mlp_apply({k: torch.as_tensor(v) for k, v in params.items()},
                       torch.as_tensor(x), tcfg)
    assert rel_err(got, want) <= (2e-6 if dtype == "float32" else 1e-12)


@pytest.mark.parametrize("tie", [True, False])
def test_logits_mask_padded_ids(tie):
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"), vocab_size=500,
                             tie_embeddings=tie, param_dtype="float64", compute_dtype="float64")
    assert tcfg.padded_vocab() == 512
    table = RNG.normal(size=(512, jcfg.d_model))
    w = RNG.normal(size=(jcfg.d_model, 512))
    x = RNG.normal(size=(2, 3, jcfg.d_model))
    want = jl.logits_from({"table": jnp.asarray(table)}, {"w": jnp.asarray(w)},
                          jnp.asarray(x), jcfg)
    got = tl.logits_from({"table": torch.as_tensor(table)}, {"w": torch.as_tensor(w)},
                         torch.as_tensor(x), tcfg)
    assert bool((got[..., 500:] == -1e30).all())
    assert rel_err(got[..., :500], np.asarray(want)[..., :500]) <= 1e-12


@pytest.mark.parametrize("S,chunk", [(64, 64), (50, 16), (7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chunked_xent_and_gradients_match(S, chunk, dtype):
    """The chunked CE (ragged last chunk, padded vocab) and its gradients
    w.r.t. the activations and the tied table, per chunk under
    torch.utils.checkpoint, against the reference's scan."""
    jcfg, tcfg = config_pair(get_smoke_config("smollm-360m"), vocab_size=500,
                             logits_chunk=chunk, param_dtype=dtype, compute_dtype=dtype)
    B, d = 2, jcfg.d_model
    x = RNG.normal(size=(B, S, d)).astype(dtype)
    table = (RNG.normal(size=(512, d)) * d**-0.5).astype(dtype)
    labels = RNG.integers(0, 500, (B, S)).astype(np.int32)
    mask = (RNG.uniform(size=(B, S)) > 0.2).astype(np.float32)

    def jloss(x, table):
        return jl.chunked_softmax_xent(x, jnp.asarray(labels), jnp.asarray(mask),
                                       {"table": table}, None, jcfg)

    want, (jgx, jgt) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                                  jnp.asarray(table))
    tx = torch.as_tensor(x).requires_grad_()
    tt = torch.as_tensor(table).requires_grad_()
    got = tl.chunked_softmax_xent(tx, torch.as_tensor(labels), torch.as_tensor(mask),
                                  {"table": tt}, None, tcfg)
    gx, gt = torch.autograd.grad(got, (tx, tt))
    tol = 2e-6  # the logits are float32 in both packages whatever the input dtype
    assert got.dtype == torch.float32  # the CE is summed in float32, as the reference's
    assert rel_err(got, want) <= tol
    assert rel_err(gx, jgx) <= 10 * tol and rel_err(gt, jgt) <= 10 * tol


def test_chunked_xent_saves_no_chunk_logits():
    """Autograd keeps no (B, c, V) logits block: the saved tensors of the
    loss's graph are the chunks' inputs, none with the vocabulary axis."""
    _, tcfg = config_pair(get_smoke_config("smollm-360m"), logits_chunk=16)
    B, S, d, V = 2, 64, tcfg.d_model, tcfg.padded_vocab()
    x = torch.randn(B, S, d, requires_grad=True)
    table = torch.randn(V, d, requires_grad=True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tl.chunked_softmax_xent(x, torch.zeros(B, S, dtype=torch.int32), torch.ones(B, S),
                                {"table": table}, None, tcfg)
    assert shapes and all(V not in s[:-1] and s[-1:] != (V,) for s in shapes
                          if len(s) == 3), shapes


@pytest.mark.parametrize("name,args", [
    ("constant_schedule", (3e-4,)),
    ("cosine_schedule", (3e-4, 10, 100)),
    ("cosine_schedule", (1e-3, 0, 50, 0.2)),
    ("wsd_schedule", (3e-4, 10, 50, 40)),
    ("wsd_schedule", (1e-2, 5, 0, 20, 0.1)),
])
def test_schedules_match(name, args):
    jfn, tfn = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray([float(jfn(jnp.asarray(s))) for s in steps])
    got = np.asarray([float(tfn(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    assert tfn(torch.tensor(1)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=5e-7, atol=0)  # 4 float32 ulps: libm's cos
