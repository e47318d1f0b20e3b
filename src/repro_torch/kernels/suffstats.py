"""Fused psi2 + psiY forward statistics: one pass over N produces both

    psiY[m, :]   = sum_n psi1[n, m] y_n
    psi2[m, m']  = v^2 exp(zterm_mm') sum_n exp(lognorm2_n + muterm_n,m,m')

Counterpart of the forward half of `repro.kernels.suffstats`:

  * `suffstats_fused_plain` — the plain PyTorch version (port of
    `suffstats_fused_jnp`): a chunked loop over N with pad weights,
    O(chunk * M^2) live. CPU tensors run it; `chip_smoke.py` holds the
    kernel against it on the card.
  * `suffstats_cuda`        — the wrapper of the hand-written CUDA kernel
    `csrc/suffstats_fwd.cu` (replaces the Pallas TPU kernel
    `suffstats_pallas`). CUDA tensors only; it raises on anything the
    kernel does not take and never falls back to the plain version.
    `LAUNCHES` counts its launches.

The reverse kernel (`suffstats_bwd_pallas`) belongs to the training slice.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0

# geometry of csrc/suffstats_fwd.cu (keep in step with its constants)
TILE = 32  # psi2 output tile edge
STAGE = 128  # datapoints a psi2 block stages per step
Y_TILE_M, Y_TILE_D, Y_STAGE = 32, 8, 64  # psiY block tile and staging run
MAX_Q = 16  # shared-memory staging is sized for Q <= 16
# N-splits are chosen so that about this many blocks run at once (4 per SM
# of a 132-SM H100). A function of the shapes only, so the summation order
# and hence the bits of the result never change from run to run.
TARGET_BLOCKS = 4 * 132


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
# the CUDA kernel's wrapper
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


def _check(mu, S, Y, Z, variance, lengthscale) -> None:
    named = {"mu": mu, "S": S, "Y": Y, "Z": Z, "variance": variance,
             "lengthscale": lengthscale}
    dev, dt = mu.device, mu.dtype
    if dev.type != "cuda":
        raise ValueError(f"suffstats_cuda takes CUDA tensors, got mu on {dev}")
    if dt not in _DTYPES:
        raise ValueError(f"suffstats_cuda takes float32 or float64, got {dt}")
    for name, t in named.items():
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; every input "
                             f"must be {dt} on {dev}")
    if mu.ndim != 2 or Y.ndim != 2 or Z.ndim != 2:
        raise ValueError("mu, S, Y, Z must be 2-D")
    N, Q = mu.shape
    M = Z.shape[0]
    if (S.shape != mu.shape or Y.shape[0] != N or Z.shape[1] != Q
            or variance.numel() != 1 or lengthscale.shape != (Q,)):
        raise ValueError(
            f"shape mismatch: mu {tuple(mu.shape)}, S {tuple(S.shape)}, "
            f"Y {tuple(Y.shape)}, Z {tuple(Z.shape)}, variance "
            f"{tuple(variance.shape)}, lengthscale {tuple(lengthscale.shape)}")
    if not 1 <= Q <= MAX_Q or M < 1 or Y.shape[1] < 1:
        raise ValueError(f"suffstats_cuda takes 1 <= Q <= {MAX_Q}, M >= 1 "
                         f"and D >= 1; got Q={Q}, M={M}, D={Y.shape[1]}")
    if max(N * max(Q, Y.shape[1]), M * M) >= 2**31:
        raise ValueError("suffstats_cuda indexes rows with 32-bit ints")
    for name in ("mu", "S", "Y", "Z"):
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
