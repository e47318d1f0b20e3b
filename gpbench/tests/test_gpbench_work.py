"""The frozen work counts against the program's own at the cells' shapes
today, and against counts worked by hand at one small shape."""
import math

import pytest
import torch

from gpbench import work
from repro_torch.launch import cost, roofline

DT = {"float32": torch.float32, "float64": torch.float64}
CELLS = [(16_777_216, 128, 1, 3, "float32"), (1_000_000, 100, 1, 3, "float64")]


@pytest.mark.parametrize("shape", CELLS)
def test_kernel_counts_equal_the_programs(shape):
    N, M, Q, D, dt = shape
    assert tuple(work.stats_fwd(*shape)) == tuple(roofline.suffstats_work(N, M, Q, D, DT[dt]))
    assert tuple(work.stats_bwd(*shape)) == tuple(roofline.suffstats_bwd_work(N, M, Q, D, DT[dt]))


@pytest.mark.parametrize("shape", CELLS)
def test_step_parts_equal_the_programs(shape):
    N, M, Q, D, dt = shape
    assert tuple(work.epilogue(M, Q, D, dt)) == tuple(cost.epilogue_part(M, Q, D, DT[dt]).work)
    assert tuple(work.pointwise(N, Q, D, dt)) == tuple(cost.pointwise_part(N, Q, D, DT[dt]).work)
    n = work.param_count(N, M, Q)
    assert n == cost.gplvm_param_count(N, M, Q)
    assert tuple(work.adam(n, dt)) == tuple(cost.adam_part(n, DT[dt]).work)


@pytest.mark.parametrize("shape", CELLS)
def test_bound_equals_the_programs(shape):
    N, M, Q, D, dt = shape
    for mine, theirs in ((work.stats_fwd, roofline.suffstats_work),
                         (work.stats_bwd, roofline.suffstats_bwd_work)):
        ms = roofline.bound(theirs(N, M, Q, D, DT[dt]), DT[dt])[0]
        assert work.bound_s(mine(*shape), dt) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_peaks_equal_the_programs():
    for name in ("HBM_BYTES_PER_S", "FP32_PER_S", "FP64_PER_S", "SFU_EXP_PER_S"):
        assert getattr(work, name) == getattr(roofline, name)


def test_counts_by_hand_at_a_small_shape():
    # N 10, M 4, Q 2, D 3: 10 pairs a point
    N, M, Q, D = 10, 4, 2, 3
    pairs = N * 10
    fwd = work.stats_fwd(N, M, Q, D, "float32")
    assert fwd.flops == pairs * 8 + N * M * 12
    assert fwd.exps == pairs + N * M
    assert fwd.nbytes == 4 * (10 * 7 + 8 + 2 + 16 + 12)
    bwd = work.stats_bwd(N, M, Q, D, "float64")
    assert bwd.flops == pairs * 25 + N * M * 34
    assert bwd.exps == pairs + N * M
    assert bwd.nbytes == 8 * (2 * 10 * 7 + 16 + 16 + 12 + 6)
    assert work.epilogue(M, Q, D, "float32") == (8 * 64 + 6 * 16 * 11, 32, 4 * (24 * 16 + 48))
    assert work.pointwise(N, Q, D, "float64") == (220 + 60, 20, 8 * (220 + 30))
    assert work.param_count(N, M, Q) == 40 + 8 + 2 + 2
    assert work.adam(52, "float32") == (14 * 52, 0, 8 * 4 * 52)
    assert work.build_epilogue(M, Q, D, "float64") == (2 * 64 / 3 + 96 + 16 * 10, 16,
                                                      8 * (8 * 16 + 36))
    assert work.build_pointwise(N, Q, D, "float32") == (60, 20, 4 * (40 + 30))
    step = work.train_step(N, M, Q, D, "float32")
    assert step.exps == 2 * (pairs + N * M) + 32 + 20


def test_exp_rule():
    w = work.Work(flops=67e12, exps=2 * work.SFU_EXP_PER_S, nbytes=0)
    assert work.bound_s(w, "float32") == pytest.approx(2.0)  # the SFUs bind
    assert work.bound_s(w, "float64") == pytest.approx((67e12 + 2 * work.SFU_EXP_PER_S) / 34e12)
    w = work.Work(flops=1, exps=0, nbytes=3.35e12)
    assert work.bound_s(w, "float64") == pytest.approx(1.0)  # the bytes bind


def test_train_step_bound_at_the_production_shape():
    # SFU exps bind: 2 (N M (M + 1) / 2 + N M) exps at 16 x 132 x 1.98e9 a second
    N, M = 16_777_216, 128
    exps = 2 * (N * M * (M + 1) // 2 + N * M) + 2 * M * M + N
    assert work.bound_s(work.train_step(N, M, 1, 3, "float32"), "float32") == pytest.approx(
        exps / work.SFU_EXP_PER_S)
    assert math.isclose(exps / work.SFU_EXP_PER_S, 0.0671, rel_tol=0.01)
