"""The host side of the launch layout of the psi1 reverse kernel (B6,
csrc/psi1_bwd.cu) and of the cross-covariance kernel of psi1 and K_fu (B5,
B7, csrc/common.cuh: cross_kernel), no card needed: the plans are pure
functions of the shapes, the rings fit a block's shared memory, every
(point, inducing point) is visited once, and the grids stay within one
wave of resident blocks.

The walks below repeat the kernels' own loops (N-splits, staged runs,
column tiles, point groups, the cross kernel's add-only row and column
stepping) in Python, so a plan that would drop or repeat an output fails
here rather than on the card.
"""
import itertools

import pytest
import torch

from repro_torch.kernels import psi1 as tp1
from repro_torch.kernels import suffstats as tss

MS = (1, 5, 13, 100, 130, 256, 257, 1000)
QS = (1, 4, 17, 32)
ITEMSIZES = (4, 8)
NS = (1, 37, 1000, 4099)
RESIDENT = 2 * 132  # a card's resident blocks, as its occupancy query would give them
THREADS = tss.PAIR_THREADS


GRID = list(itertools.product(MS, QS, ITEMSIZES))


@pytest.mark.parametrize("M,Q,itemsize", GRID)
def test_psi1_bwd_ring_fits_shared_memory(M, Q, itemsize):
    plan = tss.psi1_bwd_plan(M, Q, itemsize)
    assert plan == tss.psi1_bwd_plan(M, Q, itemsize)  # shapes only
    assert plan == tss.psi1_bwd_plan_at(M, Q, itemsize, plan.run, plan.cols)
    if plan.fast:
        assert plan.smem == tss.psi1_bwd_fast_smem(itemsize, M, Q, plan.run, plan.lanes)
        # one point a group, a lane's dZ columns within its registers
        assert Q <= 4 and plan.cols == M and plan.run * plan.lanes == THREADS
        assert -(-M // plan.lanes) <= tss.psi1_bwd_fast_columns(Q)
        assert tss.psi1_bwd_fast_columns(Q) * Q <= tss.PSI1_BWD_REG_COLUMNS
        # the ring holds the groups' dZ columns of one q at the end
        assert plan.run * M * 8 <= tss.PSI1_BWD_STAGES * plan.run * M * itemsize
    else:
        assert plan.smem == tss.psi1_bwd_smem(itemsize, M, Q, plan.run, plan.cols,
                                              plan.lanes)
    assert plan.smem <= tss.SMEM_LIMIT
    assert tss.PSI1_BWD_STAGES - 1 >= 3  # three runs in flight while one is computed
    assert 8 <= plan.run <= tss.PSI1_BWD_MAX_RUN
    assert 1 <= plan.cols <= M and (plan.cols == M or plan.cols % 32 == 0)
    # the ring holds every stage's rows (or their column tiles)
    assert plan.smem >= tss.PSI1_BWD_STAGES * plan.run * plan.cols * itemsize
    # point groups: aligned in a warp, every lane of the block in one
    assert plan.lanes in (1, 2, 4, 8, 16, 32)
    assert THREADS // plan.lanes <= 64
    if not plan.fast and plan.cols == M and plan.lanes < 32:
        assert tss._banks_distinct(M, plan.lanes, itemsize)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_psi1_bwd_plan_at_the_paper_shape(itemsize):
    """M = 100, Q = 1: the fast path, runs of 64 points (4 lanes a point, 8
    points a warp on 32 distinct banks in float, 25 dZ columns a lane);
    floats leave two blocks a multiprocessor, doubles one."""
    plan = tss.psi1_bwd_plan(100, 1, itemsize)
    assert plan.fast and plan.cols == 100 and (plan.run, plan.lanes) == (64, 4)
    assert (plan.smem <= tss.TWO_BLOCKS_SMEM) == (itemsize == 4)
    if itemsize == 4:
        assert len({(i * 100 + lane) % 32 for i in range(8) for lane in range(4)}) == 32


def test_psi1_bwd_fast_path_only_where_registers_hold_the_columns():
    assert tss.psi1_bwd_fast_lanes(100, 1, 64) == 4
    assert tss.psi1_bwd_fast_lanes(100, 5, 64) == 0  # no compile-time instance
    assert tss.psi1_bwd_fast_lanes(100, 1, 48) == 0  # not one point a group
    assert tss.psi1_bwd_fast_lanes(1025, 1, 8) == 0  # 33 columns a lane
    assert not tss.psi1_bwd_plan(2000, 1, 8).fast


def test_psi1_bwd_plan_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        tss.psi1_bwd_plan(100, 2000, 8)


def _psi1_bwd_visits(N, M, plan, P):
    """(n, m) in the order csrc/psi1_bwd.cu's blocks take them: split p's
    runs of R points, each run's column tiles, each tile's points by their
    group (point i by group i mod 256 / G), each group's lanes over the
    tile's columns."""
    R, MT, G = plan.run, plan.cols, plan.lanes
    groups = THREADS // G
    visits = []
    for n0, n1 in tss.split_bounds(N, P):
        for base in range(n0, n1, R):
            cnt = min(R, n1 - base)
            for m0 in range(0, M, MT):
                W = min(MT, M - m0)
                for i0 in range(0, cnt, groups):
                    for i in range(i0, min(i0 + groups, cnt)):
                        for lane in range(G):
                            visits += [(base + i, m0 + m) for m in range(lane, W, G)]
    return visits


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("M,Q,itemsize", [(1, 1, 4), (100, 1, 4), (100, 1, 8), (130, 3, 8),
                                          (257, 17, 4), (1000, 1, 8), (1000, 32, 8)])
def test_psi1_bwd_visits_every_output_once_in_one_wave(N, M, Q, itemsize):
    plan = tss.psi1_bwd_plan(M, Q, itemsize)
    P = tss.psi1_bwd_splits(N, plan.run, RESIDENT)
    assert 1 <= P <= RESIDENT
    assert all(hi - lo >= 1 for lo, hi in tss.split_bounds(N, P))  # no empty split
    visits = _psi1_bwd_visits(N, M, plan, P)
    assert len(visits) == len(set(visits)) == N * M


@pytest.mark.parametrize("count", (1, 3, 4, 5, 100, 6400))
@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_span_room_holds_any_shift(count, itemsize):
    """A span staged at any offset within 16 bytes fits its room, which is
    whole 16-byte chunks."""
    v = 16 // itemsize
    room = tss.span_room(count, itemsize)
    assert room % v == 0
    assert all(shift + count <= room for shift in range(v))


# ---------------------------------------------------------------------------
# the cross-covariance kernel (B5 psi1, B7 K_fu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_S", (True, False))
@pytest.mark.parametrize("M,Q,itemsize", GRID)
def test_cross_kernel_fits_shared_memory_in_one_wave(M, Q, itemsize, with_S):
    cols = tp1.cross_cols(M, Q)
    assert 1 <= cols <= M and cols * Q <= tp1.Z_TILE_ELEMS
    assert tp1.cross_smem(Q, cols, itemsize, with_S) <= tss.SMEM_LIMIT
    tiles = -(-M // cols)
    for N in NS:
        P = tp1.cross_splits(N, M, Q, RESIDENT)
        assert P >= 1 and (P * tiles <= RESIDENT or P == 1)
        assert P <= -(-N // tp1.cross_run(Q)) and N // P >= 1  # no split empty


def _cross_thread_walk(tid, cnt, W, M=None):
    """The outputs (i, m) thread `tid` stores for a run of cnt points and W
    columns, with the kernel's add-only stepping; with M, also checks the
    output offset i M + m it advances alongside."""
    di, dm = THREADS // W, THREADS % W
    step = di * (M or W) + dm
    i, m = tid // W, tid % W
    off = i * (M or W) + m
    out = []
    while i < cnt:
        assert off == i * (M or W) + m
        out.append((i, m))
        m += dm
        i += di
        off += step
        if m >= W:
            m -= W
            i += 1
            off += (M or W) - W
    return out


@pytest.mark.parametrize("W", (1, 5, 13, 100, 130, 255, 256, 257, 1000))
@pytest.mark.parametrize("cnt", (1, 7, 128))
def test_cross_stepping_is_the_row_major_walk(cnt, W):
    """Thread t's add-only walk is exactly the outputs t, t + 256, ... of
    the run in row-major order, so the block stores each output once and
    neighbouring threads store neighbouring addresses."""
    for tid in range(THREADS):
        want = [divmod(e, W) for e in range(tid, cnt * W, THREADS)]
        assert _cross_thread_walk(tid, cnt, W) == want


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("M,Q", [(1, 1), (100, 1), (257, 4), (1000, 32), (130, 17)])
def test_cross_kernel_covers_every_output_once(N, M, Q):
    cols = tp1.cross_cols(M, Q)
    P = tp1.cross_splits(N, M, Q, RESIDENT)
    R = tp1.cross_run(Q)
    seen = []
    for n0, n1 in tss.split_bounds(N, P):
        for m0 in range(0, M, cols):
            W = min(cols, M - m0)
            for base in range(n0, n1, R):
                cnt = min(R, n1 - base)
                for tid in range(min(THREADS, cnt * W)):
                    seen += [(base + i, m0 + m) for i, m in _cross_thread_walk(tid, cnt, W, M)]
    assert len(seen) == len(set(seen)) == N * M


def test_cross_cols_refuses_more_than_a_tile_of_z():
    with pytest.raises(ValueError, match="elements of Z"):
        tp1.cross_cols(10, tp1.Z_TILE_ELEMS + 1)


def test_psi2_kernels_take_any_q_that_shared_memory_holds():
    """Q = 17, 20 and 32 fit every psi2 kernel's staging in both dtypes; a
    Q whose staging would not fit is named with its bytes."""
    for lib, Q, dt in itertools.product(("suffstats_fwd", "suffstats_bwd", "psi2_fwd",
                                         "psi2_bwd"), (1, 4, 5, 16, 17, 20, 32),
                                        (torch.float32, torch.float64)):
        assert tss.kernel_smem(lib, Q, torch.finfo(dt).bits // 8) <= tss.SMEM_LIMIT
    assert tss.kernel_smem("suffstats_bwd", 200, 8) > tss.SMEM_LIMIT
