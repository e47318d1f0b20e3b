"""The port's launch tools on the CPU: `launch.roofline` (the H100 model
and the seven kernels' work counts, held to the formulas `chip_smoke.py`
carried before they moved), `launch.cost` (a step's work from its parts,
held to B1 + B2 + epilogue + per-point work + Adam and linear in N), and
`launch.gp_dryrun` at tiny N on the CPU: its step against the port's
single-process `BayesianGPLVM` facade (float64: the loss to 1e-10, the
gradients to 1e-8, as `mesh=` is held to it), against the
reference's `distributed.gplvm_loss_dist(mesh, backend="jnp")` on a
one-device mesh (the tolerances of tests/test_torch_distributed.py; the
reference's fused shard_map loss raises under the installed jax), two gloo
ranks against one, and its record end to end."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import inference
from repro_torch.gp import BayesianGPLVM
from repro_torch.kernels import ops
from repro_torch.launch import cost, gp_dryrun, roofline
from repro_torch.optim.adam import flatten

PAPER = (1_000_000, 100, 1, 3)
KERNEL_SHAPE = (100_003, 256, 4, 5)
DTYPES = (torch.float32, torch.float64)


# ---------------------------------------------------------------------------
# the bound formulas chip_smoke.py carried before they moved to the package
# ---------------------------------------------------------------------------

def _parent_bound(nbytes, flops, exps, dtype):
    t_bytes = nbytes / 3.35e12
    if dtype == torch.float32:
        t_ops, term = max((flops / 67e12, "FP32 flops"),
                          (exps / (16 * 132 * 1.98e9), "exps on the SFUs"))
    else:
        t_ops, term = (flops + exps) / 34e12, "FP64 flops and exps"
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes", "HBM bytes"
    return 1e3 * t_ops, "operations", term


def _parent(name, N, M, Q, D, dtype):
    s = torch.finfo(dtype).bits // 8
    pairs = N * M * (M + 1) // 2
    if name == "bound_ms":
        return _parent_bound(s * (N * (2 * Q + D) + M * Q + Q + M * M + M * D),
                             pairs * (3 * Q + 2) + N * M * (3 * Q + 2 * D),
                             pairs + N * M, dtype)
    if name == "bwd_bound_ms":
        return _parent_bound(s * (2 * N * (2 * Q + D) + 2 * M * Q + M * M + M * D + 2 * Q + 2),
                             pairs * (11 * Q + 3) + N * M * (10 * Q + 4 * D + 2),
                             pairs + N * M, dtype)
    if name == "psi2_bound_ms":
        return _parent_bound(s * (2 * N * Q + M * Q + Q + 1 + M * M),
                             pairs * (3 * Q + 2), pairs, dtype)
    if name == "psi2_bwd_bound_ms":
        return _parent_bound(s * (4 * N * Q + 2 * M * Q + M * M + 2 * Q + 2),
                             pairs * (11 * Q + 3), pairs, dtype)
    if name == "psi1_bound_ms":
        return _parent_bound(s * (2 * N * Q + M * Q + Q + 1 + N * M),
                             N * M * (3 * Q + 2), N * M, dtype)
    if name == "psi1_bwd_bound_ms":
        return _parent_bound(s * (4 * N * Q + N * M + 2 * M * Q + 2 * Q + 2),
                             N * M * (10 * Q + 3), N * M, dtype)
    assert name == "kfu_bound_ms"
    return _parent_bound(s * (N * Q + M * Q + Q + 1 + N * M), N * M * (3 * Q + 1), N * M,
                         dtype)


BOUNDS = ("bound_ms", "bwd_bound_ms", "psi2_bound_ms", "psi2_bwd_bound_ms",
          "psi1_bound_ms", "psi1_bwd_bound_ms", "kfu_bound_ms")


@pytest.mark.parametrize("shape", [PAPER, KERNEL_SHAPE])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", BOUNDS)
def test_bounds_equal_the_formulas_chip_smoke_carried(name, dtype, shape):
    got = getattr(roofline, name)(*shape, dtype)
    want = _parent(name, *shape, dtype)
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0], rel=1e-15)


def test_paper_shape_bounds_are_the_kernel_table_s():
    """PERF.md's table: B1 1.232 ms (SFU exps) in float32, 0.921 ms in
    float64; B5 0.122 / 0.244 ms (bytes)."""
    assert roofline.bound_ms(*PAPER, torch.float32)[:2] == (
        pytest.approx(1.232, abs=5e-4), "operations")
    assert roofline.bound_ms(*PAPER, torch.float64)[0] == pytest.approx(0.921, abs=5e-4)
    assert roofline.psi1_bound_ms(*PAPER, torch.float32)[:2] == (
        pytest.approx(0.122, abs=5e-4), "bytes")
    assert roofline.psi1_bound_ms(*PAPER, torch.float64)[0] == pytest.approx(0.244, abs=5e-4)


def test_roofline_terms_pick_the_dominant_term():
    t = roofline.roofline_terms(flops=67e12, exps=0, nbytes=3.35e12 / 2,
                                collective_bytes=0, dtype=torch.float32)
    assert t["dominant"] == "compute" and t["step_lower_bound_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(0.5) and t["compute_fraction_of_bound"] == 1.0
    t = roofline.roofline_terms(flops=0, exps=0, nbytes=0, collective_bytes=4.5e11,
                                dtype=torch.float64)
    assert t["dominant"] == "collective" and t["t_collective_s"] == pytest.approx(1.0)
    # float64 counts each exp as one FP64 operation
    t = roofline.roofline_terms(flops=17e12, exps=17e12, nbytes=0, collective_bytes=0,
                                dtype=torch.float64)
    assert t["t_compute_s"] == pytest.approx(1.0)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_ring_collectives_follow_the_reference_model(world):
    """The ring all-reduce of `repro.launch.roofline.parse_collectives`, as
    a function of the payload and W."""
    b, frac = 1_000_000.0, (world - 1) / world
    assert roofline.ring_allreduce_bytes(b, world) == pytest.approx(2 * b * frac)


# ---------------------------------------------------------------------------
# a step's cost from its parts
# ---------------------------------------------------------------------------

def _fused_step_passes(N, M=8, Q=1, D=3, dtype=torch.float64):
    rng = np.random.default_rng(0)
    Y = torch.as_tensor(rng.normal(size=(N, D)), dtype=dtype)
    model = BayesianGPLVM(M=M, Q=Q, backend="fused", device="cpu")
    params = model.init_params(Y)
    with ops.recording() as log:
        inference.value_and_grad(model._loss, params, (Y,))
    return log


@pytest.mark.parametrize("N", [256, 1000])
def test_fused_step_cost_is_b1_b2_epilogue_pointwise_and_adam(N):
    M, Q, D = 8, 1, 3
    passes = _fused_step_passes(N, M, Q, D)
    assert [(p.lib, p.N, p.M, p.Q, p.D, p.kernel) for p in passes] == [
        ("suffstats_fwd", N, M, Q, D, False), ("suffstats_bwd", N, M, Q, D, False)]
    dt = passes[0].dtype
    step = cost.gplvm_step_cost(passes, N=N, M=M, Q=Q, D=D, dtype=dt)
    parts = [roofline.suffstats_work(N, M, Q, D, dt), roofline.suffstats_bwd_work(N, M, Q, D, dt),
             cost.epilogue_part(M, Q, D, dt).work, cost.pointwise_part(N, Q, D, dt).work,
             cost.adam_part(cost.gplvm_param_count(N, M, Q), dt).work]
    assert [p.name for p in step.parts] == [
        f"suffstats_fwd N={N} M={M} Q={Q} D={D}", f"suffstats_bwd N={N} M={M} Q={Q} D={D}",
        "epilogue", "pointwise", "adam"]
    assert step.flops == sum(w.flops for w in parts)
    assert step.exps == sum(w.exps for w in parts)
    assert step.nbytes == sum(w.nbytes for w in parts)
    assert step.collective_bytes == 0
    assert len(step.table()) == 5 and json.dumps(step.table())


def test_step_cost_grows_linearly_in_n():
    M, Q, D = 8, 1, 3

    def total(N):
        dt = torch.float64
        passes = [ops.StatsPass("suffstats_fwd", N, M, Q, D, dt, True),
                  ops.StatsPass("suffstats_bwd", N, M, Q, D, dt, True)]
        c = cost.gplvm_step_cost(passes, N=N, M=M, Q=Q, D=D, dtype=dt)
        return np.array([c.flops, c.exps, c.nbytes])

    d1 = total(2000) - total(1000)
    d2 = total(3000) - total(2000)
    assert (d1 > 0).all() and np.array_equal(d1, d2)
    assert total(1000)[1] - total(0)[1] == d1[1]  # exps: per point only


def test_data_parallel_cost_adds_the_two_all_reduces():
    M, Q, D, W = 8, 1, 3, 4
    dt = torch.float32
    passes = [ops.StatsPass("suffstats_fwd", 250, M, Q, D, dt, True)]
    one = cost.gplvm_step_cost(passes, N=250, M=M, Q=Q, D=D, dtype=dt, world=1)
    four = cost.gplvm_step_cost(passes, N=250, M=M, Q=Q, D=D, dtype=dt, world=W)
    payload = 4 * (M * M + M * D + 5) + 4 * (M * Q + Q + 2)
    assert four.collective_bytes == pytest.approx(2 * payload * (W - 1) / W)
    assert four.flops == one.flops and four.parts[-1].name == f"all-reduce W={W}"


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

N_TINY, M_TINY, Q_TINY, D_TINY = 384, 8, 1, 3


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300))


@pytest.fixture(scope="module")
def tiny():
    """The dry run's problem at tiny N in float64, its loss and gradients
    through a process group of one."""
    dev = torch.device("cpu")
    params, Y = gp_dryrun.make_problem(N_TINY, M_TINY, Q_TINY, D_TINY,
                                       dtype=torch.float64, device=dev)
    with gp_dryrun.process_group(0, 1, dev):
        from repro_torch.core import distributed

        mesh = distributed.make_gp_mesh(device_type="cpu")
        loss, grads = inference.value_and_grad(gp_dryrun.loss_fn(mesh, "fused"),
                                               params, (Y,))
    return params, Y, float(loss), grads


def test_dry_run_step_equals_the_single_process_facade(tiny):
    """The loss to 1e-10; each gradient leaf to 1e-8, as
    tests/test_torch_distributed.py holds `mesh=` to the single process:
    Z's gradient is the difference of the epilogue's part and the
    statistics' part, which the data-parallel path adds in another order
    (1.6e-10 apart here)."""
    params, Y, loss, grads = tiny
    model = BayesianGPLVM(M=M_TINY, Q=Q_TINY, backend="fused", device="cpu")
    want, want_g = inference.value_and_grad(model._loss, params, (Y,))
    assert _rel(loss, float(want)) <= 1e-10
    for path, g, w in zip(flatten(grads)[0], flatten(grads)[1], flatten(want_g)[1]):
        assert _rel(g, w) <= 1e-8, path


def test_dry_run_step_equals_the_reference_one_device_mesh(tiny):
    from repro.core import distributed as jdist

    params, Y, loss, grads = tiny
    p_np = {"kern": {k: v.numpy() for k, v in params["kern"].items()},
            **{k: params[k].numpy() for k in ("Z", "log_beta", "q_mu", "q_logS")}}
    mesh = jdist.make_gp_mesh()
    want, want_g = jax.jit(jax.value_and_grad(jdist.gplvm_loss_dist(mesh, backend="jnp")))(
        jax.tree.map(jnp.asarray, p_np), jnp.asarray(Y.numpy()))
    assert _rel(loss, want) <= 1e-10
    paths, leaves = flatten(grads)
    for path, g, w in zip(paths, leaves, jax.tree.leaves(want_g)):
        assert _rel(g, w) <= 1e-8, path


def test_make_problem_is_the_reference_parameterization():
    params, Y = gp_dryrun.make_problem(1000, 16, 2, 3, dtype=torch.float32, device="cpu")
    assert Y.shape == (1000, 3) and params["q_mu"].shape == params["q_logS"].shape == (1000, 2)
    assert params["Z"].shape == (16, 2) and params["kern"]["log_lengthscale"].shape == (2,)
    assert float(params["log_beta"]) == pytest.approx(math.log(100.0))
    assert all(t.dtype == torch.float32 for t in flatten(params)[1])
    again, Y2 = gp_dryrun.make_problem(1000, 16, 2, 3, dtype=torch.float32, device="cpu")
    assert torch.equal(Y, Y2) and torch.equal(params["Z"], again["Z"])


def _as_dtype(tree, dtype):
    return {k: _as_dtype(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def test_dry_run_float32_steps_follow_float64():
    """The dry run's draw is well conditioned: on one draw (made in float64
    and rounded), STEPS float32 Adam steps give losses within 1e-3 of
    float64's, and both fall at every step. float32's relative jitter is
    100x float64's (`core.svgp`), which moves the loss by ~5e-4 here. A
    draw with 32 inducing points packed into [-2, 2] at lengthscale 1 (Kuu
    singular to float64's precision) misses this by ~0.13 and its float32
    loss rises at a step."""
    dev = torch.device("cpu")
    p64, Y64 = gp_dryrun.make_problem(1024, 32, 1, 3, dtype=torch.float64, device=dev)
    losses = {}
    with gp_dryrun.process_group(0, 1, dev):
        from repro_torch.core import distributed

        loss = gp_dryrun.loss_fn(distributed.make_gp_mesh(device_type="cpu"), "fused")
        for dtype in DTYPES:
            params, Y = _as_dtype(p64, dtype), Y64.to(dtype)
            opt = gp_dryrun.adam_init(params, gp_dryrun.ADAM)
            losses[dtype] = []
            for _ in range(gp_dryrun.STEPS):
                params, opt, value = gp_dryrun.train_step(loss, params, opt, Y)
                losses[dtype].append(float(value))
    for dtype in DTYPES:
        assert all(b < a for a, b in zip(losses[dtype], losses[dtype][1:])), losses
    np.testing.assert_allclose(losses[torch.float32], losses[torch.float64], rtol=1e-3)


def test_dry_run_record_end_to_end(tmp_path, capsys):
    out = tmp_path / "rec.json"
    rec = gp_dryrun.main(["--n", str(N_TINY), "--m", str(M_TINY), "--device", "cpu",
                          "--dtype", "float64", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert rec["backend"] == "fused" and rec["n_chips"] == 1 and rec["dtype"] == "float64"
    assert len(rec["steps_ms"]) == gp_dryrun.STEPS and rec["step_ms"] > 0
    assert all(np.isfinite(rec["losses"]))
    assert rec["memory"]["peak_bytes"] is None  # no card: not measured
    assert rec["launches"] == dict.fromkeys(rec["launches"], 0)  # plain versions
    assert [p["lib"] for p in rec["passes"]] == ["suffstats_fwd", "suffstats_bwd"]
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["flops_per_chip"] == sum(p["flops"] for p in rec["parts"])
    assert "terms: compute" in capsys.readouterr().out


def test_dry_run_default_record_goes_to_the_port_s_own_directory():
    assert gp_dryrun.OUT_DIR.parts[-2:] == ("experiments", "dryrun_torch")
    args = gp_dryrun.parse_args([])
    assert (args.n, args.m, args.q, args.d, args.backend, args.world, args.device) == (
        16_777_216, 128, 1, 3, "fused", 1, "cuda")


def test_two_gloo_ranks_take_the_one_rank_step(tmp_path):
    common = ["--n", str(N_TINY), "--m", str(M_TINY), "--device", "cpu",
              "--dtype", "float64"]
    one = gp_dryrun.main(common + ["--out", str(tmp_path / "w1.json")])
    two = gp_dryrun.main(common + ["--world", "2", "--out", str(tmp_path / "w2.json")])
    assert two["n_chips"] == 2
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-10)
    assert two["collectives"]["traffic_bytes_per_chip"] > 0
    assert two["passes"][0]["N"] == N_TINY // 2
