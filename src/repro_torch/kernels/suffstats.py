"""Fused psi2 + psiY statistics and their reverse pass: one pass over N
produces both

    psiY[m, :]   = sum_n psi1[n, m] y_n
    psi2[m, m']  = v^2 exp(zterm_mm') sum_n exp(lognorm2_n + muterm_n,m,m')

and the reverse passes of the single-statistic ops (psi1, psi2), which are
the fused rules with one branch removed. Counterpart of
`repro.kernels.suffstats`:

  * `suffstats_fused_plain` — the plain PyTorch forward (port of
    `suffstats_fused_jnp`): a chunked loop over N with pad weights,
    O(chunk * M^2) live.
  * `suffstats_vjp_plain`, `psi1_vjp_plain`, `psi2_vjp_plain` — the plain
    PyTorch reverse passes (ports of `suffstats_vjp_jnp`, `psi1_vjp_jnp`,
    `psi2_vjp_jnp`), chunked loops over one shared cotangent algebra.
  * `suffstats_cuda`        — the wrapper of the hand-written CUDA kernel
    `csrc/suffstats_fwd.cu` (replaces the Pallas TPU kernel
    `suffstats_pallas`); `LAUNCHES` counts its launches.
  * `suffstats_bwd_cuda`    — the wrapper of `csrc/suffstats_bwd.cu`
    (replaces `suffstats_bwd_pallas`); `BWD_LAUNCHES` counts its launches.
  * `psi1_bwd_cuda`, `psi2_bwd_cuda` — the wrappers of `csrc/psi1_bwd.cu`
    and `csrc/psi2_bwd.cu` (replace `psi1_bwd_pallas`, `psi2_bwd_pallas`);
    `PSI1_BWD_LAUNCHES`, `PSI2_BWD_LAUNCHES` count their launches.
  * `kfu_vjp_plain`, `kfu_bwd_cuda` — K_fu's reverse pass, the psi1 ones at
    S = 0 (ports of `kfu_vjp_jnp` and `kfu_bwd_pallas`).

CPU tensors run the plain versions; `chip_smoke.py` holds each kernel
against its plain version on the card. The kernel wrappers take CUDA
tensors only: they raise on anything their kernel does not take and never
fall back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

# incremented once per launch of the fused forward / fused reverse / psi1
# reverse / psi2 reverse CUDA kernel, and nowhere else
LAUNCHES = 0
BWD_LAUNCHES = 0
PSI1_BWD_LAUNCHES = 0
PSI2_BWD_LAUNCHES = 0

# threads of a psi2 pair block (csrc/common.cuh: kThreads); a warp is 32.
# How many pairs a block owns, how many points it stages per step and how
# many blocks a multiprocessor holds come from the library itself
# (`geometry`), so the host and the kernel cannot disagree.
PAIR_THREADS = 256
Y_TILE_M, Y_TILE_D, Y_STAGE = 32, 8, 64  # psiY block tile and staging run
# dynamic shared memory a block may use on sm_90 (227 KB): the only bound on
# Q, through each kernel's staging (`kernel_smem`)
SMEM_LIMIT = 232_448
# N-splits of the psiY and dZ blocks are chosen so that about
# this many blocks run at once (4 per SM of a 132-SM H100). A function of
# the shapes only, so the summation order and hence the bits of the result
# never change from run to run.
TARGET_BLOCKS = 4 * 132
# geometry of csrc/suffstats_bwd.cu: threads (datapoints) per point-pass
# block, and the dZ pass's inducing-point tile and staging run
BWD_THREADS = 256
Z_TILE_M, Z_STAGE = 32, 64
# geometry of csrc/psi1_bwd.cu: stages of its ring, the longest run, the
# fast path's dZ partials (column slots x Q) a lane holds in registers and
# the column slots it evaluates without a branch
PSI1_BWD_STAGES, PSI1_BWD_MAX_RUN = 4, 64
PSI1_BWD_REG_COLUMNS, PSI1_BWD_COLUMN_CHUNK = 32, 4
# shared memory that lets two psi1-reverse blocks share a multiprocessor
# (228 KB a multiprocessor, 1 KB of it reserved a block)
TWO_BLOCKS_SMEM = 228 * 1024 // 2 - 1024


# ---------------------------------------------------------------------------
# plain PyTorch version (port of suffstats_fused_jnp)
# ---------------------------------------------------------------------------

def _pad_stream(mu, S, Y, chunk):
    """Pad the N axis to a chunk multiple: S with ones (any positive value)
    and pad weights w = 0, so padded rows contribute nothing."""
    N, Q = mu.shape
    pad = (-N) % chunk
    mu_p = torch.cat([mu, mu.new_zeros(pad, Q)])
    S_p = torch.cat([S, S.new_ones(pad, Q)])
    Y_p = torch.cat([Y, Y.new_zeros(pad, Y.shape[1])])
    w = torch.cat([mu.new_ones(N), mu.new_zeros(pad)])
    return mu_p, S_p, Y_p, w


def _psi1_weighted(mu_i, S_i, w_i, Z, l2):
    """psi1 / variance for one chunk, pad weights folded in: (chunk, M)."""
    b = 1.0 / (l2[None, :] + S_i)
    lognorm1 = -0.5 * torch.log1p(S_i / l2[None, :]).sum(-1)
    expo = lognorm1[:, None].expand(-1, Z.shape[0]).clone()
    for q in range(mu_i.shape[1]):  # Q is small (latent dim)
        dq = mu_i[:, None, q] - Z[None, :, q]
        expo -= 0.5 * dq * dq * b[:, None, q]
    return torch.exp(expo) * w_i[:, None]


def _psi2_weighted(mu_i, S_i, w_i, zbar, l2):
    """Per-point psi2 factor exp(lognorm2 + muterm) without the v^2
    exp(zterm) prefactor, pad weights folded in: (chunk, M, M)."""
    r = 1.0 / (l2[None, :] + 2.0 * S_i)
    lognorm2 = -0.5 * torch.log1p(2.0 * S_i / l2[None, :]).sum(-1)
    M = zbar.shape[0]
    expo = lognorm2[:, None, None].expand(-1, M, M).clone()
    for q in range(mu_i.shape[1]):
        dq = mu_i[:, None, None, q] - zbar[None, :, :, q]
        expo -= dq * dq * r[:, None, None, q]
    return torch.exp(expo) * w_i[:, None, None]


def _psi2_prefactor(Z, variance, lengthscale):
    """v^2 exp(-|z_m - z_m'|^2 / 4 l^2), the (m, m')-only factor of psi2."""
    zdiff = Z[:, None, :] - Z[None, :, :]
    zterm = -(zdiff**2 / (4.0 * lengthscale**2)).sum(-1)
    return variance**2 * torch.exp(zterm)


def suffstats_fused_plain(mu, S, Y, Z, variance, lengthscale, *,
                          chunk: int = 1024):
    """(psi2 (M, M), psiY (M, D)) by one streaming pass over N in chunks of
    `chunk` datapoints: the same math as the CUDA kernel, O(chunk * M^2)
    live."""
    M = Z.shape[0]
    l2 = lengthscale**2
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    chunk = max(1, min(chunk, mu.shape[0]))  # pad no further than N needs
    mu_p, S_p, Y_p, w = _pad_stream(mu, S, Y, chunk)
    acc2 = mu.new_zeros(M, M)
    accY = mu.new_zeros(M, Y.shape[1])
    for i in range(0, mu_p.shape[0], chunk):
        sl = slice(i, i + chunk)
        psi1 = _psi1_weighted(mu_p[sl], S_p[sl], w[sl], Z, l2)
        accY = accY + variance * psi1.T @ Y_p[sl]
        acc2 = acc2 + _psi2_weighted(mu_p[sl], S_p[sl], w[sl], zbar, l2).sum(0)
    return _psi2_prefactor(Z, variance, lengthscale) * acc2, accY


# ---------------------------------------------------------------------------
# plain PyTorch reverse passes (ports of suffstats_vjp_jnp, psi1_vjp_jnp and
# psi2_vjp_jnp)
# ---------------------------------------------------------------------------
#
# Equation numbers are those of docs/derivations/suffstats_vjp.md. Every
# input cotangent is linear in a per-point branch weight: W1 (eq. (8)) for
# the psi1 branch, T (eq. (9)) for the psi2 branch. The two per-chunk
# helpers below hold the cotangent algebra once; the fused reverse pass runs
# both branches, the single-statistic ones (psi1, psi2) one branch each, as
# the reference's single-statistic rules are the fused ones with a branch
# removed. Per-point cotangents (dmu, dS, dY) leave chunk by chunk; the
# global ones (dZ, dvariance, dlengthscale) are carried across chunks.


def _psi1_branch(mu_i, S_i, Z, l2, ls, v, W1):
    """Cotangents of one chunk's psi1 branch given its weight W1 (c, M):
    (dmu (c, Q), dS (c, Q), dZ (M, Q), dvariance, dlengthscale (Q,)),
    eq. (10)-(14)."""
    b = 1.0 / (l2[None, :] + S_i)
    s1 = W1.sum(1)
    W1Z = W1 @ Z
    sq1 = mu_i**2 * s1[:, None] - 2.0 * mu_i * W1Z + W1 @ (Z * Z)
    dmu = -b * (mu_i * s1[:, None] - W1Z)  # eq. (10)
    dS = -0.5 * b * s1[:, None] + 0.5 * b * b * sq1  # eq. (11)
    dZ = W1.T @ (mu_i * b) - Z * (W1.T @ b)  # eq. (12)
    dv = s1.sum() / v  # eq. (13)
    dl = ((S_i * b / ls) * s1[:, None] + ls * b * b * sq1).sum(0)  # eq. (14)
    return dmu, dS, dZ, dv, dl


def _psi2_branch(mu_i, S_i, Z, zdiff, l2, ls, v, T):
    """Cotangents of one chunk's psi2 branch given its weight T (c, M, M):
    (dmu, dS, dZ, dvariance, dlengthscale), eq. (15)-(20). Since
    z1 == z2 == Z, the two dZ slot contributions of eq. (18) are evaluated
    in their symmetrized form (T + T^T)."""
    r = 1.0 / (l2[None, :] + 2.0 * S_i)
    Z2 = Z * Z
    t = T.sum((1, 2))
    rc = T.sum(2) + T.sum(1)  # row + column sums
    u = 0.5 * rc @ Z  # eq. (15)
    B = torch.einsum("nab,aq,bq->nq", T, Z, Z)
    w2 = 0.25 * (rc @ Z2) + 0.5 * B
    V = mu_i**2 * t[:, None] - 2.0 * mu_i * u + w2  # sum T (mu - zbar)^2
    dmu = -2.0 * r * (mu_i * t[:, None] - u)  # eq. (16)
    dS = -r * t[:, None] + 2.0 * r * r * V  # eq. (17)
    Ts = T + T.transpose(1, 2)
    Ps = Ts.sum(0)
    dZ = (torch.einsum("nk,nq->kq", rc, r * mu_i)
          - 0.5 * Z * torch.einsum("nk,nq->kq", rc, r)
          - 0.5 * torch.einsum("nkm,mq,nq->kq", Ts, Z, r)
          - (Z * Ps.sum(1)[:, None] - Ps @ Z) / (2.0 * l2))  # eq. (18)
    dv = 2.0 * t.sum() / v  # eq. (19)
    dl = ((2.0 / ls) * ((S_i * r) * t[:, None]).sum(0)
          + 2.0 * ls * (r * r * V).sum(0)
          + torch.einsum("ab,abq->q", T.sum(0), zdiff**2)
          / (2.0 * ls**3))  # eq. (20)
    return dmu, dS, dZ, dv, dl


def _psi2_setup(Z, v, l2, g2):
    """(zdiff (M, M, Q), zbar (M, M, Q), G2p = g2 v^2 exp(zterm)), eq. (9)."""
    zdiff = Z[:, None, :] - Z[None, :, :]
    zterm = -(zdiff**2 / (4.0 * l2)).sum(-1)
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    return zdiff, zbar, g2 * v**2 * torch.exp(zterm)


def _chunks(N: int, chunk: int):
    """Slices of [0, N) in runs of `chunk`; the last may be shorter (one
    empty slice for N = 0, whose cotangents are zeros)."""
    chunk = max(1, chunk)
    return [slice(i, min(i + chunk, N)) for i in range(0, max(N, 1), chunk)]


def _sum_chunks(parts, mu, S, Z, variance, lengthscale):
    """Concatenate the per-chunk (dmu, dS) and sum the per-chunk (dZ, dv,
    dl); each cotangent in its input's dtype."""
    dmu, dS, dZ, dv, dl = zip(*parts)
    return (torch.cat(dmu).to(mu.dtype), torch.cat(dS).to(S.dtype),
            sum(dZ).to(Z.dtype), sum(dv).to(variance.dtype),
            sum(dl).to(lengthscale.dtype))


def suffstats_vjp_plain(mu, S, Y, Z, variance, lengthscale, g2, gY, *,
                        chunk: int = 512):
    """Cotangents (dmu, dS, dY, dZ, dvariance, dlengthscale) of
    (psi2, psiY) = suffstats(...) given the output cotangents g2 (M, M)
    and gY (M, D): one streaming pass over N, O(chunk * M^2) live."""
    N, Q = mu.shape
    M = Z.shape[0]
    dt = mu.dtype
    v = variance.to(dt)
    ls = lengthscale.to(dt)
    l2 = ls**2
    zdiff, zbar, G2p = _psi2_setup(Z, v, l2, g2.to(dt))
    gY = gY.to(dt)
    chunk = max(1, min(chunk, N))
    mu_p, S_p, Y_p, w = _pad_stream(mu, S, Y, chunk)
    dZ = mu.new_zeros(M, Q)
    dv = mu.new_zeros(())
    dl = mu.new_zeros(Q)
    dmu, dS, dY = [], [], []
    for i in range(0, mu_p.shape[0], chunk):
        sl = slice(i, i + chunk)
        mu_i, S_i, Y_i, w_i = mu_p[sl], S_p[sl], Y_p[sl], w[sl]
        psi1w = v * _psi1_weighted(mu_i, S_i, w_i, Z, l2)  # (c, M)
        dY.append(psi1w @ gY)
        W1 = (Y_i @ gY.T) * psi1w  # eq. (8)
        T = G2p[None, :, :] * _psi2_weighted(mu_i, S_i, w_i, zbar, l2)  # eq. (9)
        one = _psi1_branch(mu_i, S_i, Z, l2, ls, v, W1)
        two = _psi2_branch(mu_i, S_i, Z, zdiff, l2, ls, v, T)
        dmu.append(one[0] + two[0])
        dS.append(one[1] + two[1])
        dZ, dv, dl = dZ + one[2] + two[2], dv + one[3] + two[3], dl + one[4] + two[4]
    return (torch.cat(dmu)[:N].to(mu.dtype), torch.cat(dS)[:N].to(S.dtype),
            torch.cat(dY)[:N].to(Y.dtype), dZ.to(Z.dtype),
            dv.to(variance.dtype), dl.to(lengthscale.dtype))


def psi1_vjp_plain(mu, S, Z, variance, lengthscale, g, *, chunk: int = 512):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of
    psi1 = psi1_plain(...) given the output cotangent g (N, M): the fused
    reverse pass's psi1 branch with weight W1 = g psi1 (eq. (8)
    specialized), one streaming pass over N, O(chunk * M) live. At S = 0 it
    is the reverse pass of K_fu (dS discarded)."""
    dt = mu.dtype
    v = variance.to(dt)
    ls = lengthscale.to(dt)
    l2 = ls**2
    g = g.to(dt)
    parts = []
    for sl in _chunks(mu.shape[0], chunk):
        mu_i, S_i = mu[sl], S[sl]
        W1 = g[sl] * (v * _psi1_weighted(mu_i, S_i, mu_i.new_ones(mu_i.shape[0]),
                                         Z, l2))
        parts.append(_psi1_branch(mu_i, S_i, Z, l2, ls, v, W1))
    return _sum_chunks(parts, mu, S, Z, variance, lengthscale)


def kfu_vjp_plain(X, Z, variance, lengthscale, g, *, chunk: int = 512):
    """Cotangents (dX, dZ, dvariance, dlengthscale) of
    K_fu = kfu_plain(...) given the output cotangent g (N, M): the psi1
    reverse pass at S = 0 with dS dropped (port of `kfu_vjp_jnp`)."""
    dX, _, dZ, dv, dl = psi1_vjp_plain(X, torch.zeros_like(X), Z, variance,
                                       lengthscale, g, chunk=chunk)
    return dX, dZ, dv, dl


def psi2_vjp_plain(mu, S, Z, variance, lengthscale, g2, *, chunk: int = 512):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of
    psi2 = psi2_plain(...) given the output cotangent g2 (M, M): the fused
    reverse pass's psi2 branch alone (eq. (9), (15)-(20)), one streaming
    pass over N, O(chunk * M^2) live."""
    dt = mu.dtype
    v = variance.to(dt)
    ls = lengthscale.to(dt)
    l2 = ls**2
    zdiff, zbar, G2p = _psi2_setup(Z, v, l2, g2.to(dt))
    parts = []
    for sl in _chunks(mu.shape[0], chunk):
        mu_i, S_i = mu[sl], S[sl]
        T = G2p[None, :, :] * _psi2_weighted(
            mu_i, S_i, mu_i.new_ones(mu_i.shape[0]), zbar, l2)  # eq. (9)
        parts.append(_psi2_branch(mu_i, S_i, Z, zdiff, l2, ls, v, T))
    return _sum_chunks(parts, mu, S, Z, variance, lengthscale)


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

class Geometry(NamedTuple):
    """A psi2 pair pass's launch geometry, as its library reports it."""
    pairs_per_block: int  # pair slots of a block: slots a thread x PAIR_THREADS
    blocks_per_sm: int  # resident blocks a multiprocessor holds
    run: int  # datapoints a block stages per step
    group: int  # datapoints a warp's per-point reduction takes at once (1: forward)


def pair_count(M: int) -> int:
    """The psi2 pairs a <= b: M (M + 1) / 2."""
    return M * (M + 1) // 2


def pair_of(t: int, M: int) -> tuple[int, int]:
    """The pair (a, b), a <= b, numbered t in the packed upper triangle
    (row by row); the host's copy of csrc/common.cuh: pair_of."""
    a = 0
    while t >= M - a:
        t -= M - a
        a += 1
    return a, a + t


def pair_blocks(M: int, pairs_per_block: int) -> int:
    """Pair blocks that cover the M (M + 1) / 2 pairs."""
    return -(-pair_count(M) // pairs_per_block)


def block_pairs(j: int, M: int, pairs_per_block: int) -> list:
    """The pairs of pair block j, slot by slot as the kernels number them
    (slot k of thread t is pair j ppb + k PAIR_THREADS + t); slots past the
    last pair hold none."""
    first = j * pairs_per_block
    return [pair_of(first + i, M) for i in range(pairs_per_block)
            if first + i < pair_count(M)]


def evaluated_slots(M: int, pairs_per_block: int) -> int:
    """psi2 exponentials a datapoint costs in the pair layout: 32 for every
    warp's slot that holds at least one real pair (the kernels' warp-uniform
    `live`); the rest of the pair blocks' slots are skipped."""
    npairs = pair_count(M)
    warps = PAIR_THREADS // 32
    return 32 * sum(j * pairs_per_block + k * PAIR_THREADS + 32 * w < npairs
                    for j in range(pair_blocks(M, pairs_per_block))
                    for k in range(pairs_per_block // PAIR_THREADS)
                    for w in range(warps))


def split_bounds(N: int, P: int) -> list:
    """[begin, end) of each of the P N-splits (csrc/common.cuh:
    split_range): sizes differ by at most one."""
    return [(N * p // P, N * (p + 1) // P) for p in range(P)]


def evaluated_rows(N: int, P: int, run: int, group: int) -> int:
    """Datapoint rows a pair pass evaluates over its P splits: each staged
    run rounded up to whole warp reductions of `group` points (the padding
    rows' exponentials are exactly 0)."""
    rows = 0
    for lo, hi in split_bounds(N, P):
        for base in range(lo, hi, run):
            rows += -(-min(run, hi - base) // group) * group
    return rows


class Split(NamedTuple):
    """One pass's N-split count before its clamp: the splits that `waves`
    waves of the card's resident blocks ask for, and the most the
    datapoints allow (none shorter than one run). The launch takes
    `count`; a tuned wave count is admissible only where `want <= most`."""
    want: int
    most: int

    @property
    def count(self) -> int:
        return max(1, min(self.want, self.most))


def psi2_split(N: int, M: int, geo: Geometry, sms: int, waves: int = 1) -> Split:
    """The psi2 pair pass's `Split`: as many N-splits as keep every pair
    block in `waves` waves of the card's resident blocks (blocks_per_sm x
    sms), and no split shorter than one staged run."""
    blocks = pair_blocks(M, geo.pairs_per_block)
    return Split(waves * geo.blocks_per_sm * sms // blocks, N // geo.run)


def psi2_splits(N: int, M: int, geo: Geometry, sms: int, waves: int = 1) -> int:
    """N-splits of a psi2 pair pass (`psi2_split`); at waves=1, one wave,
    so no wave is left with a handful of blocks. A pure function of the
    shapes, the geometry and the wave count: the summation order, and so
    the bits of the result, never change from run to run."""
    return psi2_split(N, M, geo, sms, waves).count


def psiy_split(N: int, M: int, D: int, waves: int = 1) -> Split:
    """The fused forward's psiY pass: about `waves` x TARGET_BLOCKS blocks,
    no split shorter than one staging run."""
    y_blocks = -(-M // Y_TILE_M) * -(-D // Y_TILE_D)
    return Split(-(-waves * TARGET_BLOCKS // y_blocks), -(-N // Y_STAGE))


def splits(N: int, M: int, D: int, geo: Geometry, sms: int,
           waves: int = 1) -> tuple[int, int]:
    """(P2, PY): N-splits of the fused forward's psi2 pair blocks
    (`psi2_splits`) and of its psiY blocks (`psiy_split`)."""
    return psi2_splits(N, M, geo, sms, waves), psiy_split(N, M, D, waves).count


DTYPES = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def bind(lib_name: str, dtype: torch.dtype, n_ptrs: int, n_ints: int):
    """(entry, error_string) of `<lib_name>_<f32|f64>` in the library
    `lib_name` (built at first use): `n_ptrs` pointers, `n_ints` ints, then
    the stream."""
    lib = _build.library(lib_name)
    fn = getattr(lib, f"{lib_name}_{DTYPES[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{lib_name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def geometry(lib_name: str, dtype: torch.dtype, Q: int, device_index: int) -> Geometry:
    """The psi2 pair pass's geometry of `lib_name`'s instance for (dtype, Q)
    on the card `device_index`, from the library (its occupancy query)."""
    lib = _build.library(lib_name)
    fn = getattr(lib, f"{lib_name}_geometry")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        rc = fn(int(dtype == torch.float64), Q, out)
    if rc != 0:
        raise RuntimeError(f"{lib_name} geometry query failed (cudaError {rc})")
    return Geometry(*out)


@functools.lru_cache(maxsize=None)
def multiprocessors(device_index: int) -> int:
    """The multiprocessor count of the card `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def card_of(t: torch.Tensor) -> tuple[int, int]:
    """(device index, multiprocessor count) of t's card."""
    dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
    return dev, multiprocessors(dev)


def card_geometry(lib_name: str, t: torch.Tensor) -> tuple[Geometry, int]:
    """(geometry, multiprocessor count) for a launch of `lib_name` on t's
    card, t being mu or X (N, Q)."""
    dev, sms = card_of(t)
    return geometry(lib_name, t.dtype, t.shape[1], dev), sms


def launch(lib_name: str, tensors, ints) -> None:
    """Launch `lib_name`'s entry for the first tensor's dtype on its device's
    current stream: pointers of `tensors`, then `ints`. Raises if the launch
    fails."""
    dev = tensors[0].device
    fn, err = bind(lib_name, tensors[0].dtype, len(tensors), len(ints))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in tensors), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{lib_name} launch failed: {err(rc).decode()} "
                           f"(cudaError {rc})")


def _psi2_fwd_smem(Q: int, itemsize: int) -> int:
    """csrc/common.cuh: psi2_smem_bytes at Q (zbar in shared memory for a
    run-time Q, kFwdSlots slots a thread up to Q = 16, then one)."""
    zbar = (4 if Q <= 16 else 1) * Q * PAIR_THREADS if Q > 4 else 0
    return 32 * 8 + itemsize * (2 * 128 * Q + 128 + zbar)


def _pair_smem(Q: int, itemsize: int) -> int:
    """csrc/reverse.cuh: pair_smem_bytes at Q."""
    if Q <= 4:
        return 32 * 8 + itemsize * (2 * 32 * Q + 32 + 8 * 32 * (1 + 3 * Q))
    # run-time Q: zbar of every q, one pass's 1 + 3 * 8 kinds, runs of 16
    return 32 * 8 + itemsize * (Q * PAIR_THREADS + 2 * 16 * Q + 16 + 8 * 16 * 25)


def kernel_smem(lib: str, Q: int, itemsize: int) -> int:
    """The most dynamic shared memory a block of library `lib` (B1-B4) needs
    at Q, from the sources' layouts: the ψ2 pair blocks, B1's psiY blocks,
    B2's point pass (at a run-time Q it holds the point's mu and b) and
    B2's dZ pass."""
    psiy = itemsize * (2 * Y_STAGE * Q + Y_STAGE + Y_STAGE * Y_TILE_D + Y_STAGE * Y_TILE_M
                       + Y_TILE_M * Q + Q)
    dz1 = itemsize * (2 * Z_STAGE * Q + Z_STAGE + BWD_THREADS)
    point = 2 * itemsize * Q * BWD_THREADS if Q > 4 else 0
    return {"suffstats_fwd": max(_psi2_fwd_smem(Q, itemsize), psiy),
            "psi2_fwd": _psi2_fwd_smem(Q, itemsize),
            "suffstats_bwd": max(_pair_smem(Q, itemsize), point, dz1),
            "psi2_bwd": _pair_smem(Q, itemsize)}[lib]


def check_inputs(mu, S, Y, Z, variance, lengthscale, *, what: str,
                 per_point: bool = False, lib: str | None = None,
                 waves: int = 1, **cotangents) -> None:
    """Raise ValueError on anything the kernel `what` does not take: CUDA
    tensors of one float dtype, matching shapes, Q >= 1 (and, for the
    library `lib`'s ψ2 kernels, no more than their shared memory holds), row
    indices within 32 bits, contiguous arrays, a positive int wave count.
    `Y` is None for the single-statistic kernels and `S` for K_fu (mu is
    then X); `per_point` kernels (and every reverse kernel) need N >= 1.
    Cotangents are checked by name: g2 (M, M), gY (M, D), g (N, M)."""
    if isinstance(waves, bool) or not isinstance(waves, int) or waves < 1:
        raise ValueError(f"{what}: waves must be a positive int, got {waves!r}")
    named = {"mu": mu, "S": S, "Y": Y, "Z": Z, "variance": variance,
             "lengthscale": lengthscale, **cotangents}
    named = {k: t for k, t in named.items() if t is not None}
    dev, dt = mu.device, mu.dtype
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got mu on {dev}")
    if dt not in DTYPES:
        raise ValueError(f"{what} takes float32 or float64, got {dt}")
    for name, t in named.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every input "
                             f"must be {dt} on {dev}")
    if mu.ndim != 2 or Z.ndim != 2 or (Y is not None and Y.ndim != 2):
        raise ValueError(f"{', '.join(k for k in ('mu', 'S', 'Y', 'Z') if k in named)} "
                         f"must be 2-D")
    N, Q = mu.shape
    M = Z.shape[0]
    D = Y.shape[1] if Y is not None else 1
    if ((S is not None and S.shape != mu.shape)
            or (Y is not None and Y.shape[0] != N)
            or Z.shape[1] != Q or variance.numel() != 1
            or lengthscale.shape != (Q,)):
        raise ValueError(
            f"shape mismatch: mu {tuple(mu.shape)}, "
            + (f"S {tuple(S.shape)}, " if S is not None else "")
            + (f"Y {tuple(Y.shape)}, " if Y is not None else "")
            + f"Z {tuple(Z.shape)}, variance {tuple(variance.shape)}, "
            f"lengthscale {tuple(lengthscale.shape)}")
    want = {"g2": (M, M), "gY": (M, D), "g": (N, M)}
    for name, t in cotangents.items():
        if t.shape != want[name]:
            raise ValueError(f"shape mismatch: {name} is {tuple(t.shape)}, "
                             f"must be {want[name]}")
    need_points = per_point or bool(cotangents)
    if Q < 1 or M < 1 or D < 1 or (need_points and N < 1):
        raise ValueError(f"{what} takes Q >= 1, M >= 1, D >= 1"
                         f"{' and N >= 1' if need_points else ''}; got N={N}, "
                         f"Q={Q}, M={M}, D={D}")
    if lib is not None and kernel_smem(lib, Q, mu.element_size()) > SMEM_LIMIT:
        raise ValueError(f"{what}: at Q={Q} a block of its kernels stages "
                         f"{kernel_smem(lib, Q, mu.element_size())} bytes of shared memory "
                         f"in {dt}, more than the {SMEM_LIMIT} a block may have")
    if max(N * max(Q, D), M * M * (Q + 1)) >= 2**31:
        raise ValueError(f"{what} indexes rows with 32-bit ints")
    for name, t in named.items():
        if t.ndim == 2 and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def suffstats_cuda(mu, S, Y, Z, variance, lengthscale, *, waves: int = 1):
    """(psi2 (M, M), psiY (M, D)) from the CUDA kernel, on mu's device and
    stream, in the input dtype; its N-splits fill `waves` waves of the
    card (`splits`). Raises on inputs the kernel does not take and if the
    launch fails."""
    global LAUNCHES
    check_inputs(mu, S, Y, Z, variance, lengthscale, what="suffstats_cuda",
                 lib="suffstats_fwd", waves=waves)
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    P2, PY = splits(N, M, D, *card_geometry("suffstats_fwd", mu), waves)
    l2 = (lengthscale * lengthscale).contiguous()
    part2 = mu.new_empty(P2, pair_count(M))
    partY = mu.new_empty(PY, M, D)
    acc2 = mu.new_empty(M, M)
    accY = mu.new_empty(M, D)
    launch("suffstats_fwd", (mu, S, Y, Z, l2, part2, partY, acc2, accY),
           (N, M, Q, D, P2, PY))
    LAUNCHES += 1
    return _psi2_prefactor(Z, variance, lengthscale) * acc2, variance * accY


def point_chunk(N: int, M: int, pairs_per_block: int) -> int:
    """Points a chunk of the reverse pair and point passes (B2, B4,
    csrc/reverse.cuh: run_chunks) takes: N over the pair-block count,
    rounded up to whole point-pass blocks, so the per-point scratch
    (pair blocks, 1 + 3Q, chunk) holds about N (1 + 3Q) sums whatever M is.
    A pure function of the shapes."""
    per = -(-N // pair_blocks(M, pairs_per_block))
    return min(N, -(-per // BWD_THREADS) * BWD_THREADS)


def chunk_bounds(N: int, chunk: int) -> list:
    """[begin, end) of each chunk of `chunk` points over N (the last may be
    shorter)."""
    return [(c0, min(N, c0 + chunk)) for c0 in range(0, N, chunk)]


def bwd_pair_split(N: int, M: int, geo: Geometry, sms: int, waves: int = 1) -> Split:
    """The reverse pair pass's `Split`: `psi2_split` over one chunk of
    `point_chunk` points; every chunk launches the same split count, so
    each split's pair sums carry from chunk to chunk."""
    return psi2_split(point_chunk(N, M, geo.pairs_per_block), M, geo, sms, waves)


def bwd_scratch(N: int, M: int, Q: int, geo: Geometry, P2: int) -> tuple:
    """(per-point sums shape, carry shape) of a reverse launch: one chunk's
    (pair blocks, 1 + 3Q, chunk) sums in the input dtype, and the splits'
    running pair sums between chunks, (2, P2, Q + 1, M (M + 1) / 2) in
    float64, empty when one chunk covers N."""
    chunk = point_chunk(N, M, geo.pairs_per_block)
    pt = (pair_blocks(M, geo.pairs_per_block), 1 + 3 * Q, chunk)
    return pt, ((2, P2, Q + 1, pair_count(M)) if chunk < N else (0,))


def dz_split(N: int, M: int, waves: int = 1) -> Split:
    """The fused reverse kernel's dZ pass: about `waves` x TARGET_BLOCKS
    blocks over its inducing-point tiles, no split shorter than one
    staging run."""
    tiles = -(-M // Z_TILE_M)
    return Split(-(-waves * TARGET_BLOCKS // tiles), -(-N // Z_STAGE))


def bwd_splits(N: int, M: int, geo: Geometry, sms: int,
               waves: int = 1) -> tuple[int, int]:
    """(P2, PZ): N-splits of the reverse kernel's pair pass
    (`bwd_pair_split` with its own geometry) and of its dZ pass
    (`dz_split`). Pure functions of the shapes, the geometry and the wave
    count."""
    return bwd_pair_split(N, M, geo, sms, waves).count, dz_split(N, M, waves).count


def _folded_g2(Z, variance, lengthscale, g2):
    """(G2p, Gw): the psi2 cotangent with the (m, m')-only prefactor folded
    in (eq. (9)), and what the pair pass reads: E is symmetric, so it
    visits a <= b with weight G2p + G2p^T (G2p's own diagonal on a == b)."""
    G2p = g2 * _psi2_prefactor(Z, variance, lengthscale)
    Gw = (torch.triu(G2p + G2p.T, 1) + torch.diag(G2p.diagonal())).contiguous()
    return G2p, Gw


def _psi2_dZ(Z, l2, G2p, pair_sum):
    """The psi2 part of dZ (eq. (18)) from the pair pass's sums
    P_ab = sum_n E_nab and A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq):
    an O(M^2 Q) epilogue."""
    Gsym = G2p + G2p.T
    P, A = pair_sum[0], pair_sum[1:]
    GP = Gsym * P
    return (torch.einsum("km,qkm->kq", Gsym, A)
            - (Z * GP.sum(1)[:, None] - GP @ Z) / (2.0 * l2))


def suffstats_bwd_cuda(mu, S, Y, Z, variance, lengthscale, g2, gY, *,
                       waves: int = 1):
    """Cotangents (dmu, dS, dY, dZ, dvariance, dlengthscale) from the CUDA
    reverse kernel given g2 (M, M) and gY (M, D), on mu's device and
    stream, in the input dtype; its N-splits fill `waves` waves of the card
    (`bwd_splits`). Raises on inputs the kernel does not take and if the
    launch fails.

    The (m, m')-only prefactor is folded into the psi2 cotangent before the
    launch (eq. (9)); the kernel returns the per-point cotangents, dl and
    v dv summed over the points, and the pair sums P_ab = sum_n E_nab and
    A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq), which the O(M^2 Q)
    epilogue here turns into the psi2 part of dZ (eq. (18)). Scratch: the
    pair pass's packed partials, their running totals between chunks and
    one chunk's per-(pair block, point) sums (`bwd_scratch`): about
    N (1 + 3Q) elements, with no pair-block x N factor."""
    global BWD_LAUNCHES
    check_inputs(mu, S, Y, Z, variance, lengthscale, what="suffstats_bwd_cuda",
                 lib="suffstats_bwd", waves=waves, g2=g2, gY=gY)
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    geo, sms = card_geometry("suffstats_bwd", mu)
    P2, PZ = bwd_splits(N, M, geo, sms, waves)
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    G2p, Gw = _folded_g2(Z, variance, lengthscale, g2)
    gyv = (variance * gY).contiguous()
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    dY = mu.new_empty(N, D)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    pair_part = mu.new_empty(P2, Q + 1, pair_count(M))
    pair_sum = mu.new_empty(Q + 1, M, M)
    pt_shape, carry_shape = bwd_scratch(N, M, Q, geo, P2)
    pt = mu.new_empty(pt_shape)
    carry = mu.new_empty(carry_shape, dtype=torch.float64)
    dz_part, dz1 = mu.new_empty(PZ, M, Q), mu.new_empty(M, Q)
    launch("suffstats_bwd", (mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part,
                             point_sum, pair_part, pair_sum, carry, pt, dz_part, dz1),
           (N, M, Q, D, P2, PZ, NB, pt_shape[2]))
    BWD_LAUNCHES += 1
    dZ = dz1 + _psi2_dZ(Z, l2, G2p, pair_sum)
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, dY, dZ, dv, point_sum[:Q]


def psi2_bwd_cuda(mu, S, Z, variance, lengthscale, g2, *, waves: int = 1):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of psi2 from the
    CUDA reverse kernel `csrc/psi2_bwd.cu` (replaces `psi2_bwd_pallas`)
    given g2 (M, M), on mu's device and stream, in the input dtype, its
    N-splits filling `waves` waves of the card (`bwd_pair_split`): the
    fused reverse kernel's pair and point passes without the psi1 branch,
    chunk by chunk over N, the same folded cotangent, scratch
    (`bwd_scratch`) and dZ epilogue. Raises on inputs the kernel does not
    take and if the launch fails."""
    global PSI2_BWD_LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi2_bwd_cuda",
                 lib="psi2_bwd", waves=waves, g2=g2)
    N, Q = mu.shape
    M = Z.shape[0]
    geo, sms = card_geometry("psi2_bwd", mu)
    P2 = bwd_pair_split(N, M, geo, sms, waves).count
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    G2p, Gw = _folded_g2(Z, variance, lengthscale, g2)
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    pair_part = mu.new_empty(P2, Q + 1, pair_count(M))
    pair_sum = mu.new_empty(Q + 1, M, M)
    pt_shape, carry_shape = bwd_scratch(N, M, Q, geo, P2)
    pt = mu.new_empty(pt_shape)
    carry = mu.new_empty(carry_shape, dtype=torch.float64)
    launch("psi2_bwd", (mu, S, Z, l2, ls, Gw, dmu, dS, point_part, point_sum,
                        pair_part, pair_sum, carry, pt), (N, M, Q, P2, NB, pt_shape[2]))
    PSI2_BWD_LAUNCHES += 1
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, _psi2_dZ(Z, l2, G2p, pair_sum), dv, point_sum[:Q]


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def span_room(count: int, itemsize: int) -> int:
    """Shared-memory elements a staged span of `count` elements can take
    (csrc/common.cuh: span_room): count plus the largest 16-byte shift, in
    whole 16-byte chunks."""
    v = 16 // itemsize
    return -(-(count + v - 1) // v) * v


class Psi1BwdPlan(NamedTuple):
    """csrc/psi1_bwd.cu's launch plan: a function of (M, Q, dtype) only."""
    run: int  # R: datapoints a staged run
    cols: int  # MT: inducing points a column tile (M: one tile)
    lanes: int  # G: threads a datapoint's row sums take
    smem: int  # dynamic shared-memory bytes a block
    fast: bool  # the fast path: each lane's dZ columns in registers


def psi1_bwd_smem(itemsize: int, M: int, Q: int, R: int, MT: int, G: int) -> int:
    """Bytes of csrc/psi1_bwd.cu: psi1_bwd_layout (mirrored): the ring of
    stages (g, mu, S), exp2_neg's table, the groups' dl / dv sums, the
    per-point sums across column tiles, the run's per-point terms and row
    offsets."""
    tiled = MT < M
    g_room = R * span_room(MT, itemsize) if tiled else span_room(R * M, itemsize)
    stage = (g_room + 2 * span_room(R * Q, itemsize)) * itemsize
    return (PSI1_BWD_STAGES * stage + 32 * 8
            + _round16((PAIR_THREADS // G) * (Q + 1) * 8)
            + (_round16(R * (1 + 2 * Q) * 8) if tiled else 0)
            + 4 * _round16(R * Q * itemsize) + _round16(R * itemsize) + _round16(R * 4))


def psi1_bwd_fast_smem(itemsize: int, M: int, Q: int, R: int, G: int) -> int:
    """Bytes of csrc/psi1_bwd.cu: psi1_bwd_fast_layout (mirrored): the ring,
    exp2_neg's table, Z transposed, the groups' dl / dv sums."""
    stage = (span_room(R * M, itemsize) + 2 * span_room(R * Q, itemsize)) * itemsize
    return (PSI1_BWD_STAGES * stage + 32 * 8 + _round16(M * Q * itemsize)
            + _round16((PAIR_THREADS // G) * (Q + 1) * 8))


def psi1_bwd_fast_columns(Q: int) -> int:
    """Column slots a lane of the fast path holds at Q (csrc/psi1_bwd.cu:
    fast_columns): PSI1_BWD_REG_COLUMNS / Q in whole chunks."""
    return PSI1_BWD_REG_COLUMNS // Q // PSI1_BWD_COLUMN_CHUNK * PSI1_BWD_COLUMN_CHUNK


def psi1_bwd_fast_lanes(M: int, Q: int, R: int) -> int:
    """G of the fast path at run length R (one point a group: G = 256 / R),
    or 0 where it does not apply: Q > 4 (no compile-time instance), R not a
    power of two in [8, 64], or more columns a lane than its registers hold."""
    if Q > 4 or R not in (8, 16, 32, 64):
        return 0
    G = PAIR_THREADS // R
    return G if -(-M // G) <= psi1_bwd_fast_columns(Q) else 0


def _banks_distinct(M: int, G: int, itemsize: int) -> bool:
    """Do a warp's first reads of staged g (lanes l < G of rows i < 32 / G
    at element i M + l) hit distinct banks? A bank sweep serves 32 floats
    or 16 doubles."""
    words = 32 if itemsize == 4 else 16
    addrs = [i * M + lane for i in range(32 // G) for lane in range(G)]
    return all(len({a % words for a in addrs[h:h + words]}) == len(addrs[h:h + words])
               for h in range(0, 32, words))


def psi1_bwd_lanes(M: int, R: int, itemsize: int) -> int:
    """G: threads a datapoint takes, so that the block's 256 threads cover
    min(64, R) points at once (a power of two), widened until a warp's reads
    of g hit distinct banks (32, one row a warp, always does)."""
    groups = min(64, 1 << (R.bit_length() - 1))
    G = PAIR_THREADS // groups
    while G < 32 and not _banks_distinct(M, G, itemsize):
        G *= 2
    return G


def psi1_bwd_plan_at(M: int, Q: int, itemsize: int, R: int, MT: int = 0) -> Psi1BwdPlan:
    """The plan at run length R (and column tile MT; 0: one tile): the fast
    path where `psi1_bwd_fast_lanes` allows it, else the general one."""
    MT = MT or M
    G = psi1_bwd_fast_lanes(M, Q, R) if MT == M else 0
    if G:
        return Psi1BwdPlan(R, M, G, psi1_bwd_fast_smem(itemsize, M, Q, R, G), True)
    G = 32 if MT < M else psi1_bwd_lanes(M, R, itemsize)
    return Psi1BwdPlan(R, MT, G, psi1_bwd_smem(itemsize, M, Q, R, MT, G), False)


@functools.lru_cache(maxsize=None)
def psi1_bwd_plan(M: int, Q: int, itemsize: int) -> Psi1BwdPlan:
    """The launch plan of csrc/psi1_bwd.cu at (M, Q, dtype): the longest run
    of the fast path (64, 32, 16 or 8 points) whose ring fits a block; else
    the general path's longest run (at most 64 points, at least 32) that
    fits two blocks a multiprocessor, else one (at least 8); else runs of 8
    points over column tiles of the widest multiple of 32 that fits. Raises
    ValueError where nothing fits (Q too large for shared memory). The
    fast path's runs were timed at the paper's shape
    (scripts/psi2_kernels.py --b6-runs): 64 points beat 32, 16 and 8 in
    both dtypes, even where 64 doubles leave one block a multiprocessor."""
    for R in (64, 32, 16, 8):
        if psi1_bwd_fast_lanes(M, Q, R):
            p = psi1_bwd_plan_at(M, Q, itemsize, R)
            if p.smem <= SMEM_LIMIT:
                return p
    limits = ((TWO_BLOCKS_SMEM, 32), (SMEM_LIMIT, 8))
    for limit, least in limits:
        for R in range(PSI1_BWD_MAX_RUN, least - 1, -1):
            p = psi1_bwd_plan_at(M, Q, itemsize, R)
            if not p.fast and p.smem <= limit:
                return p
    for MT in range((M - 1) // 32 * 32, 0, -32):
        p = psi1_bwd_plan_at(M, Q, itemsize, 8, MT)
        if p.smem <= SMEM_LIMIT:
            return p
    raise ValueError(f"psi1 reverse kernel: Q={Q} needs more than the {SMEM_LIMIT} bytes "
                     f"of shared memory a block may have, even at 8 points and 32 "
                     f"inducing points a stage")


def psi1_bwd_split(N: int, R: int, resident: int, waves: int = 1) -> Split:
    """csrc/psi1_bwd.cu's blocks: `waves` waves of the card's `resident`
    blocks, no split shorter than one run (and so none empty)."""
    return Split(waves * resident, -(-N // R))


def psi1_bwd_splits(N: int, R: int, resident: int, waves: int = 1) -> int:
    """N-splits (blocks) of csrc/psi1_bwd.cu (`psi1_bwd_split`). A function
    of the shapes, the card and the wave count only, so the summation
    order, and the bits of the result, never change from run to run."""
    return psi1_bwd_split(N, R, resident, waves).count


@functools.lru_cache(maxsize=None)
def psi1_bwd_occupancy(dtype: torch.dtype, M: int, Q: int, plan: Psi1BwdPlan,
                       device_index: int) -> int:
    """Resident psi1-reverse blocks a multiprocessor for this plan, from
    the library's occupancy query; checks that the library lays out the
    shared memory the plan counted."""
    lib = _build.library("psi1_bwd")
    fn = lib.psi1_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        rc = fn(int(dtype == torch.float64), M, Q, plan.run, plan.cols, plan.lanes,
                int(plan.fast), out)
    if rc != 0:
        raise RuntimeError(f"psi1_bwd occupancy query failed (cudaError {rc})")
    if out[1] != plan.smem:
        raise RuntimeError(f"psi1_bwd lays out {out[1]} bytes of shared memory, the "
                           f"plan counted {plan.smem}")
    return out[0]


def psi1_bwd_cuda(mu, S, Z, variance, lengthscale, g, *, waves: int = 1):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of psi1 from the
    CUDA reverse kernel `csrc/psi1_bwd.cu` (replaces `psi1_bwd_pallas`;
    at S = 0 it is the reverse pass of K_fu) given g (N, M), on mu's device
    and stream, in the input dtype, its blocks filling `waves` waves of the
    card (`psi1_bwd_splits`). Raises on inputs the kernel does not take and
    if the launch fails. Scratch: the blocks' dZ and dl / dv
    totals in double, (P, M, Q) and (P, Q + 1)."""
    global PSI1_BWD_LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi1_bwd_cuda",
                 waves=waves, g=g)
    N, Q = mu.shape
    M = Z.shape[0]
    plan = psi1_bwd_plan(M, Q, mu.element_size())
    dev, sms = card_of(mu)
    P = psi1_bwd_splits(N, plan.run, psi1_bwd_occupancy(mu.dtype, M, Q, plan, dev) * sms,
                        waves)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    v = variance.reshape(1).contiguous()
    Zt = Z.T.contiguous()
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    dz_acc = mu.new_empty(P, M, Q, dtype=torch.float64)
    dl_part = mu.new_empty(P, Q + 1, dtype=torch.float64)
    dZ, point_sum = mu.new_empty(M, Q), mu.new_empty(Q + 1)
    launch("psi1_bwd", (mu, S, Zt, l2, ls, v, g, dmu, dS, dz_acc, dl_part, dZ, point_sum),
           (N, M, Q, P, plan.run, plan.cols, plan.lanes, int(plan.fast)))
    PSI1_BWD_LAUNCHES += 1
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, dZ, dv, point_sum[:Q]


def kfu_bwd_cuda(X, Z, variance, lengthscale, g, *, waves: int = 1):
    """Cotangents (dX, dZ, dvariance, dlengthscale) of K_fu given g (N, M)
    from the psi1 reverse kernel at S = 0 (port of `kfu_bwd_pallas`, which
    wraps `psi1_bwd_pallas` the same way): one launch of
    `csrc/psi1_bwd.cu` at `waves`, counted by `PSI1_BWD_LAUNCHES`. Raises
    where `psi1_bwd_cuda` does."""
    dX, _, dZ, dv, dl = psi1_bwd_cuda(X, torch.zeros_like(X), Z, variance,
                                      lengthscale, g, waves=waves)
    return dX, dZ, dv, dl
