"""The host side of the psi2 kernels' launch layout (no card needed): the
packed pair numbering, the pair blocks' slots, the exponentials a point
costs, and the N-split chooser, as `repro_torch.kernels.suffstats` mirrors
them from csrc/common.cuh and csrc/reverse.cuh.

The geometries are those the libraries report for their instances (pairs
a block owns, staged run, points a warp reduces together); the resident
blocks per multiprocessor are given here, as the card's occupancy query
would give them.
"""
import pytest

from repro_torch.kernels import suffstats as tss

MS = (1, 2, 31, 32, 33, 100, 256, 257)
# the forward's blocks (4 slots a thread), the reverse pair pass at Q = 1
# (4 slots, 4 points a warp reduction), at Q = 3, 4 (2 slots, 2 points) and
# its run-time-Q instance (1 slot, 1 point)
GEOMETRIES = (tss.Geometry(1024, 4, 128, 1), tss.Geometry(1024, 2, 32, 4),
              tss.Geometry(512, 2, 32, 2), tss.Geometry(256, 1, 16, 1))
NS = (1, 2, 15, 16, 17, 31, 32, 33, 127, 128, 129, 4099, 100_003)


def test_pair_numbering_is_the_packed_upper_triangle_row_by_row():
    for M in MS:
        want = [(a, b) for a in range(M) for b in range(a, M)]
        assert [tss.pair_of(t, M) for t in range(tss.pair_count(M))] == want


@pytest.mark.parametrize("ppb", sorted({g.pairs_per_block for g in GEOMETRIES}))
@pytest.mark.parametrize("M", MS)
def test_pair_blocks_visit_every_pair_once_and_none_past_M(M, ppb):
    seen = [p for j in range(tss.pair_blocks(M, ppb))
            for p in tss.block_pairs(j, M, ppb)]
    assert len(seen) == len(set(seen)) == tss.pair_count(M)
    assert set(seen) == {(a, b) for a in range(M) for b in range(a, M)}
    assert all(a <= b < M for a, b in seen)
    # the last block holds a real pair; a block more would hold none
    assert tss.block_pairs(tss.pair_blocks(M, ppb) - 1, M, ppb)
    assert not tss.block_pairs(tss.pair_blocks(M, ppb), M, ppb)


@pytest.mark.parametrize("ppb", sorted({g.pairs_per_block for g in GEOMETRIES}))
@pytest.mark.parametrize("M", MS)
def test_exponentials_per_point_waste_less_than_a_warp(M, ppb):
    npairs = tss.pair_count(M)
    slots = tss.evaluated_slots(M, ppb)
    assert npairs <= slots < npairs + 32 and slots % 32 == 0
    if M in (100, 256):  # the paper's and the second shape: <= 3 % padded
        assert slots <= 1.03 * npairs
    assert tss.evaluated_slots(100, ppb) == 5056
    assert tss.evaluated_slots(256, ppb) == 32_896


@pytest.mark.parametrize("N", NS)
def test_splits_cover_N_without_gap_or_overlap(N):
    for P in sorted({1, 2, 3, 7, 64, N}):
        bounds = tss.split_bounds(N, P)
        assert bounds[0][0] == 0 and bounds[-1][1] == N
        assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))
        sizes = [hi - lo for lo, hi in bounds]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 0


@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("N", NS)
def test_split_choice_is_a_pure_function_of_shapes_and_occupancy(N, M, geo):
    sms = 132
    P = tss.psi2_splits(N, M, geo, sms)
    assert P == tss.psi2_splits(N, M, tss.Geometry(*geo), sms)
    blocks = tss.pair_blocks(M, geo.pairs_per_block)
    resident = geo.blocks_per_sm * sms
    assert P >= 1
    assert P == 1 or blocks * P <= resident  # never a second, partial wave
    assert P == 1 or N // P >= geo.run  # no split shorter than a staged run
    if N >= geo.run * resident:  # N large enough: the wave is full to
        assert resident - blocks * P < blocks  # within one block per pair block
    # more resident blocks never give fewer splits
    more = tss.Geometry(geo.pairs_per_block, geo.blocks_per_sm + 1, geo.run, geo.group)
    assert tss.psi2_splits(N, M, more, sms) >= P


@pytest.mark.parametrize("geo", GEOMETRIES, ids=str)
@pytest.mark.parametrize("N", NS)
def test_evaluated_rows_pad_each_run_to_whole_warp_reductions(N, geo):
    P = tss.psi2_splits(N, 100, geo, 132)
    rows = tss.evaluated_rows(N, P, geo.run, geo.group)
    runs = sum(-(-(hi - lo) // geo.run) for lo, hi in tss.split_bounds(N, P))
    assert N <= rows <= N + runs * (geo.group - 1)
    if geo.group == 1:
        assert rows == N


@pytest.mark.parametrize("N", [1, 255, 256, 20_011, 1_000_003, 16_777_216])
@pytest.mark.parametrize("M,Q,ppb", [(5, 1, 1024), (100, 1, 1024), (128, 1, 1024),
                                     (256, 4, 512), (1000, 20, 256)])
def test_reverse_chunks_bound_the_point_scratch(N, M, Q, ppb):
    """The reverse passes' chunks tile N in whole point-pass blocks (all
    but the last), and their per-point scratch holds about N (1 + 3Q)
    sums with no pair-block x N factor; the pair sums' carry is left out
    where one chunk covers N."""
    geo = tss.Geometry(ppb, 2, 32, 4)
    chunk = tss.point_chunk(N, M, ppb)
    bounds = tss.chunk_bounds(N, chunk)
    assert bounds[0][0] == 0 and bounds[-1][1] == N
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all((hi - lo) % tss.BWD_THREADS == 0 for lo, hi in bounds[:-1])
    blocks = tss.pair_blocks(M, ppb)
    assert len(bounds) <= blocks
    P2 = tss.bwd_pair_split(N, M, geo, 132).count
    pt, carry = tss.bwd_scratch(N, M, Q, geo, P2)
    assert pt == (blocks, 1 + 3 * Q, chunk)
    assert blocks * chunk <= N + blocks * tss.BWD_THREADS
    assert carry == ((2, P2, Q + 1, tss.pair_count(M)) if len(bounds) > 1 else (0,))
