"""The frozen work counts against the program's own at the cells' shapes
today, and against counts worked by hand at one small shape. The
program's counts have no matrix-product term: the frozen ones' is 0
wherever the program counts the same part."""
import math

import pytest
import torch

from gpbench import work
from repro_torch.launch import cost, roofline

DT = {"float32": torch.float32, "float64": torch.float64}
CELLS = [(16_777_216, 128, 1, 3, "float32"), (1_000_000, 100, 1, 3, "float64")]


def _same(mine, theirs):
    return tuple(mine) == tuple(theirs) + (0,)


@pytest.mark.parametrize("shape", CELLS)
def test_kernel_counts_equal_the_programs(shape):
    N, M, Q, D, dt = shape
    assert _same(work.stats_fwd(*shape), roofline.suffstats_work(N, M, Q, D, DT[dt]))
    assert _same(work.stats_bwd(*shape), roofline.suffstats_bwd_work(N, M, Q, D, DT[dt]))
    assert _same(work.kfu_fwd(*shape), roofline.kfu_work(N, M, Q, D, DT[dt]))


@pytest.mark.parametrize("shape", CELLS)
def test_step_parts_equal_the_programs(shape):
    N, M, Q, D, dt = shape
    assert _same(work.epilogue(M, Q, D, dt), cost.epilogue_part(M, Q, D, DT[dt]).work)
    assert _same(work.pointwise(N, Q, D, dt), cost.pointwise_part(N, Q, D, DT[dt]).work)
    n = work.param_count(N, M, Q)
    assert n == cost.gplvm_param_count(N, M, Q)
    assert _same(work.adam(n, dt), cost.adam_part(n, DT[dt]).work)


@pytest.mark.parametrize("shape", CELLS)
def test_bound_equals_the_programs(shape):
    N, M, Q, D, dt = shape
    for mine, theirs in ((work.stats_fwd, roofline.suffstats_work),
                         (work.stats_bwd, roofline.suffstats_bwd_work),
                         (work.kfu_fwd, roofline.kfu_work)):
        ms = roofline.bound(theirs(N, M, Q, D, DT[dt]), DT[dt])[0]
        assert work.bound_s(mine(*shape), dt) * 1e3 == pytest.approx(ms, rel=1e-12)


def test_peaks_equal_the_programs():
    for name in ("HBM_BYTES_PER_S", "FP32_PER_S", "FP64_PER_S", "SFU_EXP_PER_S",
                 "FP64_TENSOR_PER_S"):
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
    assert work.epilogue(M, Q, D, "float32") == (8 * 64 + 6 * 16 * 11, 32, 4 * (24 * 16 + 48), 0)
    assert work.pointwise(N, Q, D, "float64") == (220 + 60, 20, 8 * (220 + 30), 0)
    assert work.param_count(N, M, Q) == 40 + 8 + 2 + 2
    assert work.adam(52, "float32") == (14 * 52, 0, 8 * 4 * 52, 0)
    assert work.build_epilogue(M, Q, D, "float64") == (2 * 64 / 3 + 96 + 16 * 10, 16,
                                                      8 * (8 * 16 + 36), 0)
    assert work.build_pointwise(N, Q, D, "float32") == (60, 20, 4 * (40 + 30), 0)
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


def test_regression_counts_by_hand_at_a_small_shape():
    # N 10, M 4, Q 2, D 3
    N, M, Q, D = 10, 4, 2, 3
    assert work.kfu_fwd(N, M, Q, D, "float64") == (N * M * 7, N * M, 8 * (20 + 8 + 2 + 1 + 40), 0)
    assert work.kfu_bwd(N, M, Q, D, "float32") == (N * M * 23, N * M,
                                                   4 * (40 + 40 + 16 + 4 + 2), 0)
    stats = work.exact_stats(N, M, Q, D, "float64")
    assert stats == (N * M * 7, N * M, 8 * (50 + 8 + 2 + 1 + 16 + 12), N * 4 * 5 + 2 * N * 4 * 3)
    back = work.exact_stats_bwd(N, M, Q, D, "float64")
    assert back == (N * M * 23, N * M, 8 * (50 + 16 + 4 + 2 + 16 + 12), 2 * N * 16 + 2 * N * 12)
    assert work.sgpr_param_count(M, Q) == 8 + 2 + 2
    step = work.sgpr_train_step(N, M, Q, D, "float64")
    assert step.mm_flops == stats.mm_flops + back.mm_flops
    assert step.exps == 2 * N * M + 32
    assert step.nbytes == stats.nbytes + back.nbytes + 8 * (24 * 16 + 4 * M * D) + 8 * N * D \
        + 8 * 8 * 12


def test_product_rule():
    """Products run on the FP64 tensor cores beside the FP64 pipes, and on
    the FP32 pipes with the other float32 operations."""
    w = work.Work(flops=34e12, exps=0, nbytes=0, mm_flops=2 * 67e12)
    assert work.bound_s(w, "float64") == pytest.approx(2.0)
    assert work.bound_s(w, "float32") == pytest.approx((34e12 + 2 * 67e12) / 67e12)


def test_regression_step_bound_at_the_paper_shape():
    # the products bind: (N M (M + 1) + 2 N M D) + (2 N M^2 + 2 N M D) at 67 TFLOP/s
    N, M, D = 1_000_000, 100, 3
    mm = N * M * (M + 1) + 2 * N * M * D + 2 * N * M * M + 2 * N * M * D
    assert work.bound_s(work.sgpr_train_step(N, M, 1, D, "float64"), "float64") == pytest.approx(
        mm / work.FP64_TENSOR_PER_S)
    assert math.isclose(mm / work.FP64_TENSOR_PER_S, 4.67e-4, rel_tol=0.01)
