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

import torch

from repro_torch.kernels import _build

# incremented once per launch of the fused forward / fused reverse / psi1
# reverse / psi2 reverse CUDA kernel, and nowhere else
LAUNCHES = 0
BWD_LAUNCHES = 0
PSI1_BWD_LAUNCHES = 0
PSI2_BWD_LAUNCHES = 0

# geometry of csrc/suffstats_fwd.cu (keep in step with its constants)
TILE = 32  # psi2 output tile edge
STAGE = 128  # datapoints a psi2 block stages per step
Y_TILE_M, Y_TILE_D, Y_STAGE = 32, 8, 64  # psiY block tile and staging run
MAX_Q = 16  # shared-memory staging is sized for Q <= 16
# N-splits are chosen so that about this many blocks run at once (4 per SM
# of a 132-SM H100). A function of the shapes only, so the summation order
# and hence the bits of the result never change from run to run.
TARGET_BLOCKS = 4 * 132
# geometry of csrc/suffstats_bwd.cu: threads (datapoints) per point-pass
# block, and the dZ pass's inducing-point tile and staging run
BWD_THREADS = 256
Z_TILE_M, Z_STAGE = 32, 64
# geometry of csrc/psi1_bwd.cu: inducing points (lanes) per block and
# datapoints per staged run
PSI1_BWD_LANES, PSI1_BWD_RUN = 32, 64


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

def splits(N: int, M: int, D: int) -> tuple[int, int]:
    """(P2, PY): how many N-splits the psi2 and psiY blocks take, so that
    about TARGET_BLOCKS blocks are in flight and no split is shorter than
    one staging run."""
    tiles = -(-M // TILE)
    tri = tiles * (tiles + 1) // 2  # upper-triangular psi2 tiles
    p2 = min(-(-TARGET_BLOCKS // tri), -(-N // STAGE))
    y_blocks = -(-M // Y_TILE_M) * -(-D // Y_TILE_D)
    py = min(-(-TARGET_BLOCKS // y_blocks), -(-N // Y_STAGE))
    return max(1, p2), max(1, py)


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


def check_inputs(mu, S, Y, Z, variance, lengthscale, *, what: str,
                 per_point: bool = False, **cotangents) -> None:
    """Raise ValueError on anything the kernel `what` does not take: CUDA
    tensors of one float dtype, matching shapes, 1 <= Q <= MAX_Q, row
    indices within 32 bits, contiguous arrays. `Y` is None for the
    single-statistic kernels and `S` for K_fu (mu is then X); `per_point`
    kernels (and every reverse kernel) need N >= 1. Cotangents are checked
    by name: g2 (M, M), gY (M, D), g (N, M)."""
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
    if not 1 <= Q <= MAX_Q or M < 1 or D < 1 or (need_points and N < 1):
        raise ValueError(f"{what} takes 1 <= Q <= {MAX_Q}, M >= 1, D >= 1"
                         f"{' and N >= 1' if need_points else ''}; got N={N}, "
                         f"Q={Q}, M={M}, D={D}")
    if max(N * max(Q, D), M * M * (Q + 1)) >= 2**31:
        raise ValueError(f"{what} indexes rows with 32-bit ints")
    for name, t in named.items():
        if t.ndim == 2 and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def suffstats_cuda(mu, S, Y, Z, variance, lengthscale):
    """(psi2 (M, M), psiY (M, D)) from the CUDA kernel, on mu's device and
    stream, in the input dtype. Raises on inputs the kernel does not take
    and if the launch fails."""
    global LAUNCHES
    check_inputs(mu, S, Y, Z, variance, lengthscale, what="suffstats_cuda")
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    P2, PY = splits(N, M, D)
    l2 = (lengthscale * lengthscale).contiguous()
    part2 = mu.new_empty(P2, M, M)
    partY = mu.new_empty(PY, M, D)
    acc2 = mu.new_empty(M, M)
    accY = mu.new_empty(M, D)
    launch("suffstats_fwd", (mu, S, Y, Z, l2, part2, partY, acc2, accY),
           (N, M, Q, D, P2, PY))
    LAUNCHES += 1
    return _psi2_prefactor(Z, variance, lengthscale) * acc2, variance * accY


def bwd_splits(N: int, M: int) -> tuple[int, int]:
    """(P2, PZ): N-splits of the reverse kernel's pair pass (as the
    forward's psi2) and of its dZ pass. Functions of the shapes only."""
    tiles = -(-M // Z_TILE_M)
    pz = min(-(-TARGET_BLOCKS // tiles), -(-N // Z_STAGE))
    return splits(N, M, 1)[0], max(1, pz)


def _folded_g2(Z, variance, lengthscale, g2):
    """(G2p, Gw): the psi2 cotangent with the (m, m')-only prefactor folded
    in (eq. (9)), and what the point pass reads: E is symmetric, so it
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


def suffstats_bwd_cuda(mu, S, Y, Z, variance, lengthscale, g2, gY):
    """Cotangents (dmu, dS, dY, dZ, dvariance, dlengthscale) from the CUDA
    reverse kernel given g2 (M, M) and gY (M, D), on mu's device and
    stream, in the input dtype. Raises on inputs the kernel does not take
    and if the launch fails.

    The (m, m')-only prefactor is folded into the psi2 cotangent before the
    launch (eq. (9)); the kernel returns the per-point cotangents, dl and
    v dv summed over the points, and the pair sums P_ab = sum_n E_nab and
    A_abq = sum_n E_nab r_nq (mu_nq - zbar_abq), which the O(M^2 Q)
    epilogue here turns into the psi2 part of dZ (eq. (18))."""
    global BWD_LAUNCHES
    check_inputs(mu, S, Y, Z, variance, lengthscale, what="suffstats_bwd_cuda",
                 g2=g2, gY=gY)
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    P2, PZ = bwd_splits(N, M)
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    G2p, Gw = _folded_g2(Z, variance, lengthscale, g2)
    gyv = (variance * gY).contiguous()
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    dY = mu.new_empty(N, D)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    pair_part, pair_sum = mu.new_empty(P2, Q + 1, M, M), mu.new_empty(Q + 1, M, M)
    dz_part, dz1 = mu.new_empty(PZ, M, Q), mu.new_empty(M, Q)
    launch("suffstats_bwd", (mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part,
                             point_sum, pair_part, pair_sum, dz_part, dz1),
           (N, M, Q, D, P2, PZ, NB))
    BWD_LAUNCHES += 1
    dZ = dz1 + _psi2_dZ(Z, l2, G2p, pair_sum)
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, dY, dZ, dv, point_sum[:Q]


def psi2_bwd_cuda(mu, S, Z, variance, lengthscale, g2):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of psi2 from the
    CUDA reverse kernel `csrc/psi2_bwd.cu` (replaces `psi2_bwd_pallas`)
    given g2 (M, M), on mu's device and stream, in the input dtype: the
    fused reverse kernel's point and pair passes without the psi1 branch,
    the same folded cotangent and dZ epilogue. Raises on inputs the kernel
    does not take and if the launch fails."""
    global PSI2_BWD_LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi2_bwd_cuda",
                 g2=g2)
    N, Q = mu.shape
    M = Z.shape[0]
    P2 = bwd_splits(N, M)[0]
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    G2p, Gw = _folded_g2(Z, variance, lengthscale, g2)
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    pair_part, pair_sum = mu.new_empty(P2, Q + 1, M, M), mu.new_empty(Q + 1, M, M)
    launch("psi2_bwd", (mu, S, Z, l2, ls, Gw, dmu, dS, point_part, point_sum,
                        pair_part, pair_sum), (N, M, Q, P2, NB))
    PSI2_BWD_LAUNCHES += 1
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, _psi2_dZ(Z, l2, G2p, pair_sum), dv, point_sum[:Q]


def psi1_bwd_splits(N: int, M: int) -> int:
    """N-splits of the psi1 reverse kernel's tile pass: about TARGET_BLOCKS
    blocks of (32 inducing points, split), no split shorter than one staged
    run. A function of the shapes only."""
    tiles = -(-M // PSI1_BWD_LANES)
    return max(1, min(-(-TARGET_BLOCKS // tiles), -(-N // PSI1_BWD_RUN)))


def psi1_bwd_cuda(mu, S, Z, variance, lengthscale, g):
    """Cotangents (dmu, dS, dZ, dvariance, dlengthscale) of psi1 from the
    CUDA reverse kernel `csrc/psi1_bwd.cu` (replaces `psi1_bwd_pallas`;
    at S = 0 it is the reverse pass of K_fu) given g (N, M), on mu's device
    and stream, in the input dtype. Raises on inputs the kernel does not
    take and if the launch fails."""
    global PSI1_BWD_LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi1_bwd_cuda", g=g)
    N, Q = mu.shape
    M = Z.shape[0]
    P = psi1_bwd_splits(N, M)
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    v = variance.reshape(1).contiguous()
    pt = mu.new_empty(-(-M // PSI1_BWD_LANES), N, 1 + 2 * Q)
    dz_part, dZ = mu.new_empty(P, M, Q), mu.new_empty(M, Q)
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    launch("psi1_bwd", (mu, S, Z, l2, ls, v, g, pt, dz_part, dZ, dmu, dS,
                        point_part, point_sum), (N, M, Q, P, NB))
    PSI1_BWD_LAUNCHES += 1
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, dZ, dv, point_sum[:Q]


def kfu_bwd_cuda(X, Z, variance, lengthscale, g):
    """Cotangents (dX, dZ, dvariance, dlengthscale) of K_fu given g (N, M)
    from the psi1 reverse kernel at S = 0 (port of `kfu_bwd_pallas`, which
    wraps `psi1_bwd_pallas` the same way): one launch of
    `csrc/psi1_bwd.cu`, counted by `PSI1_BWD_LAUNCHES`. Raises where
    `psi1_bwd_cuda` does."""
    dX, _, dZ, dv, dl = psi1_bwd_cuda(X, torch.zeros_like(X), Z, variance,
                                      lengthscale, g)
    return dX, dZ, dv, dl
