"""The regression's reference (`gpbench/reference/sgpr.py`) against the
program's own path, the facade's `SparseGPRegression._loss` through the
model's adapter (`gpbench/models/SparseGPRegression.py`), on the CPU in
float64 at a small size: the loss and every gradient leaf, and three Adam
steps held by the check to the cell's limits."""
import pytest
import torch

from gpbench import check, harness
from gpbench.reference import sgpr as RS
from repro_torch.core import inference
from repro_torch.optim.adam import flatten

F64 = torch.float64
SGPR = harness.model_of("SparseGPRegression")
SHAPE = dict(harness.load_cell("sgpr-paper.fit").config, N=2048, M=16)
PERTURB = {"Z": 0.3, "log_lengthscale": 0.2, "log_variance": 0.2, "log_beta": 0.2}


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    monkeypatch.setattr(RS, "BLOCK_ELEMENTS", 5000)  # many blocks, a ragged last one


@pytest.mark.parametrize("backend", ["pallas", "jnp"])
@pytest.mark.parametrize("seed,perturb", [(3, None), (2**31 + 5, None), (3, PERTURB)])
def test_loss_and_gradient(backend, seed, perturb):
    """The cell's own draw, and one with the globals moved off its grid. (On
    seed 2^31 + 5 moved so, the reference alone moves log_lengthscale's
    gradient by 1.6e-10 between two block sizes: the bound's terms cancel
    there, so that case says nothing at 1e-10.)"""
    params, data = SGPR.draw(SHAPE, seed, "cpu", perturb)
    prog = SGPR.Program(dict(SHAPE, backend=backend), lr=1e-2, device="cpu")
    lp, gp = inference.value_and_grad(prog.gp._loss, params, data)
    lr, gr = RS.value_and_grad(params, *data, RS.Numerics.of("float64", F64))
    assert float(lr) == pytest.approx(float(lp), rel=1e-10)
    names, got = flatten(gp)
    assert names == flatten(gr)[0]
    for name, a, b in zip(names, got, flatten(gr)[1]):
        assert float((a - b).norm() / b.norm()) < 1e-10, name


def test_three_steps_hold_the_cells_limits():
    seed = 2**31 + 9
    params, data = SGPR.draw(SHAPE, seed, "cpu")
    prog = SGPR.Program(SHAPE, lr=1e-2, device="cpu")
    opt = prog.adam_init(params)
    p, losses, m1 = params, [], None
    for _ in range(3):
        p, opt, loss = prog.train_step(p, opt, data)
        losses.append(float(loss))
        if m1 is None:
            m1 = opt.m
    ref = RS.train(params, *data, 3, 1e-2, RS.Numerics.of("float64", F64))
    numbers = check.train_numbers({"losses": losses, "m1": m1, "params": p}, ref, params)
    ok, shown = check.verdict(numbers, harness.load_cell("sgpr-paper.fit").limits)
    assert ok, shown


def test_the_draw_is_the_gplvms_with_its_latents_observed():
    gplvm = harness.model_of("BayesianGPLVM")
    shape = dict(harness.load_cell("gplvm-paper.fit").config, N=1000, M=16)
    p_l, (Y_l,) = gplvm.draw(shape, 12, "cpu")
    p_r, (X, Y) = SGPR.draw(dict(shape, model="SparseGPRegression"), 12, "cpu")
    assert torch.equal(X, p_l["q_mu"]) and torch.equal(Y, Y_l)
    assert sorted(p_r) == ["Z", "kern", "log_beta"]
    for k in ("Z", "log_beta"):
        assert torch.equal(p_r[k], p_l[k])
