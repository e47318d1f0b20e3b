"""The benchmark's reference against the program's CPU path in float64 at
small sizes: loss, every gradient leaf, Adam's update and the built
state."""
import math

import pytest
import torch

from gpbench import problem
from gpbench.reference import gplvm as R
from repro_torch.core import gplvm, inference
from repro_torch.gp.kernels import RBF
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.adam import flatten
from repro_torch.serve.state import build_state

F64 = torch.float64


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(R, "BLOCK_ELEMENTS", 5000)  # many blocks, a ragged last one


def _problem(Q, seed=3):
    shape = {"N": 901, "M": 12, "Q": Q, "D": 3, "dtype": "float64"}
    perturb = {"Z": 0.3, "log_lengthscale": 0.2, "log_variance": 0.2, "log_beta": 0.2}
    params, Y = problem.draw(shape, seed, "cpu", perturb)
    g = torch.Generator().manual_seed(seed)
    params["q_logS"] = params["q_logS"] + 0.2 * torch.randn(params["q_logS"].shape, generator=g,
                                                            dtype=F64)
    return params, Y


@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_loss_and_gradient(Q, backend):
    params, Y = _problem(Q)
    loss = lambda p, y: gplvm.loss(p, y, kernel=RBF(Q), backend=backend)  # noqa: E731
    lp, gp = inference.value_and_grad(loss, params, (Y,))
    lr, gr = R.value_and_grad(params, Y, R.Numerics.of("float64", F64))
    assert float(lr) == pytest.approx(float(lp), rel=1e-12)
    for (name, a), b in zip(zip(*flatten(gp)), flatten(gr)[1]):
        assert float((a - b).norm() / b.norm()) < 1e-10, name


def test_adam_update_is_the_programs():
    params, Y = _problem(1)
    loss = lambda p, y: gplvm.loss(p, y, kernel=RBF(1), backend="jnp")  # noqa: E731
    _, grads = inference.value_and_grad(loss, params, (Y,))
    cfg = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
    state = adam_init(params, cfg)
    ref_state = R.adam_init(R.cast(params, F64))
    p, rp = params, R.cast(params, F64)
    for _ in range(3):
        p, state, _ = adam_update(grads, state, p, cfg)
        rp, ref_state = R.adam_update(grads, ref_state, rp, 1e-2)
    for (name, a), b in zip(zip(*flatten(p)), flatten(rp)[1]):
        assert torch.equal(a, b), name
    for a, b in zip(flatten(state.m)[1], flatten(ref_state.m)[1]):
        assert torch.equal(a, b)


def test_three_steps_follow_the_program():
    params, Y = _problem(1)
    ref = R.train(params, Y, 3, 1e-2, R.Numerics.of("float64", F64))
    loss = lambda p, y: gplvm.loss(p, y, kernel=RBF(1), backend="fused")  # noqa: E731
    cfg = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
    state, p, losses = adam_init(params, cfg), params, []
    for _ in range(3):
        value, grads = inference.value_and_grad(loss, p, (Y,))
        p, state, _ = adam_update(grads, state, p, cfg)
        losses.append(float(value))
    assert losses == pytest.approx(ref["losses"], rel=1e-12)
    for a, b in zip(flatten(p)[1], flatten(ref["params"])[1]):
        assert float((a - b).abs().max()) < 1e-9


@pytest.mark.parametrize("Q", [1, 2])
def test_built_state(Q):
    params, Y = _problem(Q)
    kern = RBF(Q)
    state = build_state(kern, params, gplvm.local_stats(params, Y, kernel=kern, backend="fused"))
    ref = R.build(params, Y, R.Numerics.of("float64", F64))
    for name in ("psi0", "psi2", "psiY", "yy", "n"):
        a, b = getattr(state.stats, name), getattr(ref.stats, name)
        assert float((a - b).norm() / b.norm()) < 1e-12, name
    for name in ("L", "LA", "Kuu_inv_mean"):
        a, b = getattr(state, name), getattr(ref, name)
        assert float((a - b).norm() / b.norm()) < 1e-10, name


def test_float32_jitter_is_the_configurations():
    params, Y = _problem(1)
    p32 = R.cast(params, torch.float32)
    kern = RBF(1)
    state = build_state(kern, p32, gplvm.local_stats(p32, Y.float(), kernel=kern, backend="fused"))
    ref = R.build(p32, Y.float(), R.Numerics.of("float64", torch.float32))
    assert float((state.L.double() - ref.L).norm() / ref.L.norm()) < 1e-5


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-12, -3.0, 63.49],
                     dtype=torch.float32)
    got = R.to_tf32(x)
    want = [1.0, 1 + 2**-10, 1.0, 1 + 2**-9, 1.0, -3.0, 63.5]
    assert got.tolist() == want
    y = torch.randn(1000, dtype=torch.float32) * 100
    rel = ((R.to_tf32(y) - y).abs() / y.abs()).max()
    assert float(rel) <= 2**-11


def test_reference_in_lower_precision_differs():
    params, Y = _problem(1)
    ref = R.value_and_grad(params, Y, R.Numerics.of("float64", F64))[0]
    low = R.value_and_grad(params, Y, R.Numerics.of("float32", F64))[0]
    assert low.dtype == torch.float32
    assert 0 < abs(float(low) - float(ref)) / abs(float(ref)) < 1e-4
    assert math.isfinite(float(R.value_and_grad(params, Y, R.Numerics.of("tf32", torch.float32))[0]))
