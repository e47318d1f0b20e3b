"""Fused psi2 + psiY statistics and their reverse pass: one pass over N
produces both

    psiY[m, :]   = sum_n psi1[n, m] y_n
    psi2[m, m']  = v^2 exp(zterm_mm') sum_n exp(lognorm2_n + muterm_n,m,m')

Counterpart of `repro.kernels.suffstats`:

  * `suffstats_fused_plain` — the plain PyTorch forward (port of
    `suffstats_fused_jnp`): a chunked loop over N with pad weights,
    O(chunk * M^2) live.
  * `suffstats_vjp_plain`   — the plain PyTorch reverse pass (port of
    `suffstats_vjp_jnp`), same loop.
  * `suffstats_cuda`        — the wrapper of the hand-written CUDA kernel
    `csrc/suffstats_fwd.cu` (replaces the Pallas TPU kernel
    `suffstats_pallas`); `LAUNCHES` counts its launches.
  * `suffstats_bwd_cuda`    — the wrapper of `csrc/suffstats_bwd.cu`
    (replaces `suffstats_bwd_pallas`); `BWD_LAUNCHES` counts its launches.

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

# incremented once per launch of the forward / reverse CUDA kernel, and
# nowhere else
LAUNCHES = 0
BWD_LAUNCHES = 0

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
# plain PyTorch reverse pass (port of suffstats_vjp_jnp)
# ---------------------------------------------------------------------------
#
# Equation numbers are those of docs/derivations/suffstats_vjp.md. Per-point
# cotangents (dmu, dS, dY) leave chunk by chunk; the global ones (dZ,
# dvariance, dlengthscale) are carried across chunks. Since z1 == z2 == Z,
# the two dZ slot contributions of eq. (18) are evaluated in their
# symmetrized form (T + T^T).

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
    g2 = g2.to(dt)
    gY = gY.to(dt)
    zdiff = Z[:, None, :] - Z[None, :, :]  # (M, M, Q)
    zterm = -(zdiff**2 / (4.0 * l2)).sum(-1)
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    G2p = g2 * v**2 * torch.exp(zterm)  # eq. (9): the (m, m')-only prefactor
    Z2 = Z * Z
    chunk = max(1, min(chunk, N))
    mu_p, S_p, Y_p, w = _pad_stream(mu, S, Y, chunk)
    dZ = mu.new_zeros(M, Q)
    dv = mu.new_zeros(())
    dl = mu.new_zeros(Q)
    dmu, dS, dY = [], [], []
    for i in range(0, mu_p.shape[0], chunk):
        sl = slice(i, i + chunk)
        mu_i, S_i, Y_i, w_i = mu_p[sl], S_p[sl], Y_p[sl], w[sl]
        # ---------------- psi1 branch (eq. (8), (10)-(14)) ----------------
        b = 1.0 / (l2[None, :] + S_i)
        psi1w = v * _psi1_weighted(mu_i, S_i, w_i, Z, l2)  # (c, M)
        W1 = (Y_i @ gY.T) * psi1w  # eq. (8)
        dY.append(psi1w @ gY)
        s1 = W1.sum(1)
        W1Z = W1 @ Z
        sq1 = mu_i**2 * s1[:, None] - 2.0 * mu_i * W1Z + W1 @ Z2
        dmu_i = -b * (mu_i * s1[:, None] - W1Z)  # eq. (10)
        dS_i = -0.5 * b * s1[:, None] + 0.5 * b * b * sq1  # eq. (11)
        dZ_c = W1.T @ (mu_i * b) - Z * (W1.T @ b)  # eq. (12)
        dv_c = s1.sum() / v  # eq. (13)
        dl_c = ((S_i * b / ls) * s1[:, None] + ls * b * b * sq1).sum(0)  # eq. (14)
        # ---------------- psi2 branch (eq. (9), (15)-(20)) ----------------
        r = 1.0 / (l2[None, :] + 2.0 * S_i)
        T = G2p[None, :, :] * _psi2_weighted(mu_i, S_i, w_i, zbar, l2)  # eq. (9)
        t = T.sum((1, 2))
        rc = T.sum(2) + T.sum(1)  # row + column sums
        u = 0.5 * rc @ Z  # eq. (15)
        B = torch.einsum("nab,aq,bq->nq", T, Z, Z)
        w2 = 0.25 * (rc @ Z2) + 0.5 * B
        V = mu_i**2 * t[:, None] - 2.0 * mu_i * u + w2  # sum T (mu - zbar)^2
        dmu.append(dmu_i - 2.0 * r * (mu_i * t[:, None] - u))  # eq. (16)
        dS.append(dS_i - r * t[:, None] + 2.0 * r * r * V)  # eq. (17)
        # eq. (18), symmetrized
        Ts = T + T.transpose(1, 2)
        Ps = Ts.sum(0)
        dZ_c = dZ_c - (Z * Ps.sum(1)[:, None] - Ps @ Z) / (2.0 * l2)
        dZ_c = (dZ_c + torch.einsum("nk,nq->kq", rc, r * mu_i)
                - 0.5 * Z * torch.einsum("nk,nq->kq", rc, r)
                - 0.5 * torch.einsum("nkm,mq,nq->kq", Ts, Z, r))
        dv_c = dv_c + 2.0 * t.sum() / v  # eq. (19)
        dl_c = (dl_c + (2.0 / ls) * ((S_i * r) * t[:, None]).sum(0)
                + 2.0 * ls * (r * r * V).sum(0)
                + torch.einsum("ab,abq->q", T.sum(0), zdiff**2)
                / (2.0 * ls**3))  # eq. (20)
        dZ, dv, dl = dZ + dZ_c, dv + dv_c, dl + dl_c
    return (torch.cat(dmu)[:N].to(mu.dtype), torch.cat(dS)[:N].to(S.dtype),
            torch.cat(dY)[:N].to(Y.dtype), dZ.to(Z.dtype),
            dv.to(variance.dtype), dl.to(lengthscale.dtype))


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


_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


@functools.lru_cache(maxsize=None)
def _entry(suffix: str):
    lib = _build.library("suffstats_fwd")
    fn = getattr(lib, f"suffstats_fwd_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.suffstats_fwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _check(mu, S, Y, Z, variance, lengthscale, *, what: str = "suffstats_cuda",
           **cotangents) -> None:
    named = {"mu": mu, "S": S, "Y": Y, "Z": Z, "variance": variance,
             "lengthscale": lengthscale, **cotangents}
    dev, dt = mu.device, mu.dtype
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got mu on {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"{what} takes float32 or float64, got {dt}")
    for name, t in named.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every input "
                             f"must be {dt} on {dev}")
    if mu.ndim != 2 or Y.ndim != 2 or Z.ndim != 2:
        raise ValueError("mu, S, Y, Z must be 2-D")
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    if (S.shape != mu.shape or Y.shape[0] != N or Z.shape[1] != Q
            or variance.numel() != 1 or lengthscale.shape != (Q,)):
        raise ValueError(
            f"shape mismatch: mu {tuple(mu.shape)}, S {tuple(S.shape)}, "
            f"Y {tuple(Y.shape)}, Z {tuple(Z.shape)}, variance "
            f"{tuple(variance.shape)}, lengthscale {tuple(lengthscale.shape)}")
    if cotangents and (cotangents["g2"].shape != (M, M)
                       or cotangents["gY"].shape != (M, D)):
        raise ValueError(
            f"shape mismatch: g2 {tuple(cotangents['g2'].shape)} and gY "
            f"{tuple(cotangents['gY'].shape)} must be ({M}, {M}) and ({M}, {D})")
    if not 1 <= Q <= MAX_Q or M < 1 or D < 1 or (cotangents and N < 1):
        raise ValueError(f"{what} takes 1 <= Q <= {MAX_Q}, M >= 1, D >= 1"
                         f"{' and N >= 1' if cotangents else ''}; got N={N}, "
                         f"Q={Q}, M={M}, D={D}")
    if max(N * max(Q, D), M * M * (Q + 1)) >= 2**31:
        raise ValueError(f"{what} indexes rows with 32-bit ints")
    for name in ("mu", "S", "Y", "Z", *cotangents):
        if not named[name].is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def suffstats_cuda(mu, S, Y, Z, variance, lengthscale):
    """(psi2 (M, M), psiY (M, D)) from the CUDA kernel, on mu's device and
    stream, in the input dtype. Raises on inputs the kernel does not take
    and if the launch fails."""
    global LAUNCHES
    _check(mu, S, Y, Z, variance, lengthscale)
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    P2, PY = splits(N, M, D)
    l2 = (lengthscale * lengthscale).contiguous()
    part2 = mu.new_empty(P2, M, M)
    partY = mu.new_empty(PY, M, D)
    acc2 = mu.new_empty(M, M)
    accY = mu.new_empty(M, D)
    fn, err = _entry(_DTYPES[mu.dtype])
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream(mu.device).cuda_stream
        rc = fn(mu.data_ptr(), S.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                l2.data_ptr(), part2.data_ptr(), partY.data_ptr(),
                acc2.data_ptr(), accY.data_ptr(), N, M, Q, D, P2, PY, stream)
    if rc != 0:
        raise RuntimeError(f"suffstats_fwd launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return _psi2_prefactor(Z, variance, lengthscale) * acc2, variance * accY


def bwd_splits(N: int, M: int) -> tuple[int, int]:
    """(P2, PZ): N-splits of the reverse kernel's pair pass (as the
    forward's psi2) and of its dZ pass. Functions of the shapes only."""
    tiles = -(-M // Z_TILE_M)
    pz = min(-(-TARGET_BLOCKS // tiles), -(-N // Z_STAGE))
    return splits(N, M, 1)[0], max(1, pz)


@functools.lru_cache(maxsize=None)
def _bwd_entry(suffix: str):
    lib = _build.library("suffstats_bwd")
    fn = getattr(lib, f"suffstats_bwd_{suffix}")
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.suffstats_bwd_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


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
    _check(mu, S, Y, Z, variance, lengthscale, what="suffstats_bwd_cuda",
           g2=g2, gY=gY)
    N, Q = mu.shape
    M, D = Z.shape[0], Y.shape[1]
    P2, PZ = bwd_splits(N, M)
    NB = -(-N // BWD_THREADS)
    ls = lengthscale.contiguous()
    l2 = (ls * ls).contiguous()
    G2p = g2 * _psi2_prefactor(Z, variance, lengthscale)  # eq. (9)
    # E is symmetric: the point pass visits a <= b with weight G2p + G2p^T
    Gw = (torch.triu(G2p + G2p.T, 1) + torch.diag(G2p.diagonal())).contiguous()
    gyv = (variance * gY).contiguous()
    dmu, dS = mu.new_empty(N, Q), mu.new_empty(N, Q)
    dY = mu.new_empty(N, D)
    point_part, point_sum = mu.new_empty(NB, Q + 1), mu.new_empty(Q + 1)
    pair_part, pair_sum = mu.new_empty(P2, Q + 1, M, M), mu.new_empty(Q + 1, M, M)
    dz_part, dz1 = mu.new_empty(PZ, M, Q), mu.new_empty(M, Q)
    fn, err = _bwd_entry(_DTYPES[mu.dtype])
    with torch.cuda.device(mu.device):
        stream = torch.cuda.current_stream(mu.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (
            mu, S, Y, Z, l2, ls, Gw, gyv, dmu, dS, dY, point_part, point_sum,
            pair_part, pair_sum, dz_part, dz1)), N, M, Q, D, P2, PZ, NB, stream)
    if rc != 0:
        raise RuntimeError(f"suffstats_bwd launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    BWD_LAUNCHES += 1
    # epilogue: eq. (18) from the pair sums
    Gsym = G2p + G2p.T
    P, A = pair_sum[0], pair_sum[1:]
    GP = Gsym * P
    dZ = (dz1 + torch.einsum("km,qkm->kq", Gsym, A)
          - (Z * GP.sum(1)[:, None] - GP @ Z) / (2.0 * l2))
    dv = (point_sum[Q] / variance).reshape(variance.shape)
    return dmu, dS, dY, dZ, dv, point_sum[:Q]
