"""The psi1 statistic of the Bayesian GP-LVM (paper §3):

    psi1[n, m] = v prod_q (1 + S_nq / l_q^2)^(-1/2)
                 exp(-1/2 (mu_nq - z_mq)^2 / (l_q^2 + S_nq))

(at S = 0, the cross covariance K_fu). Counterpart of `repro.kernels.psi1`:

  * `psi1_plain` — the plain PyTorch version, (N, M) at once.
  * `psi1_cuda`  — the wrapper of the hand-written CUDA kernel
    `csrc/psi1_fwd.cu` (replaces the Pallas TPU kernel `psi1_pallas`);
    `LAUNCHES` counts its launches.

CPU tensors run the plain version; the wrapper takes CUDA tensors only and
never falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.suffstats import (Split, _psi1_weighted, card_of,
                                           check_inputs, launch)

# incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0
# the kernel stages at most this many elements of Z per block (cols * Q)
Z_TILE_ELEMS = 2048


# ---------------------------------------------------------------------------
# the launch geometry of csrc/common.cuh: cross_kernel (B5 here, B7 in kfu.py)
# ---------------------------------------------------------------------------

def cross_cols(M: int, Q: int) -> int:
    """Inducing points a block's Z tile holds: all M when M Q is small."""
    if Q > Z_TILE_ELEMS:
        raise ValueError(f"the cross-covariance kernel stages at most {Z_TILE_ELEMS} "
                         f"elements of Z a block; Q={Q} is more")
    return min(M, Z_TILE_ELEMS // Q)


def cross_run(Q: int) -> int:
    """Datapoints a block stages a run (csrc/common.cuh: cross_run)."""
    return 128 if Q <= 16 else 32


def cross_smem(Q: int, cols: int, itemsize: int, with_S: bool) -> int:
    """Bytes of csrc/common.cuh: cross_smem_bytes: exp2_neg's table, the Z
    tile, 1 / l2 and two buffers of a run's per-point terms."""
    per_buf = cross_run(Q) * (2 * Q + 1 if with_S else Q)
    return 32 * 8 + itemsize * (cols * Q + Q + 2 * per_buf)


def cross_split(N: int, M: int, Q: int, resident: int, waves: int = 1) -> Split:
    """A cross-covariance launch's `Split`: its grid (splits x Z tiles)
    fills `waves` waves of the card's `resident` blocks, no split shorter
    than one run."""
    tiles = -(-M // cross_cols(M, Q))
    return Split(waves * resident // tiles, -(-N // cross_run(Q)))


def cross_splits(N: int, M: int, Q: int, resident: int, waves: int = 1) -> int:
    """N-splits of a cross-covariance launch (`cross_split`). A function of
    the shapes, the card and the wave count only."""
    return cross_split(N, M, Q, resident, waves).count


@functools.lru_cache(maxsize=None)
def cross_occupancy(lib_name: str, dtype: torch.dtype, Q: int, cols: int,
                    device_index: int) -> int:
    """Resident blocks a multiprocessor of `lib_name` (psi1_fwd or kfu_fwd)
    at (Q, cols), from the library's occupancy query; checks that it lays
    out the shared memory `cross_smem` counts."""
    fn = getattr(_build.library(lib_name), f"{lib_name}_geometry")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device_index):
        rc = fn(int(dtype == torch.float64), Q, cols, out)
    if rc != 0:
        raise RuntimeError(f"{lib_name} occupancy query failed (cudaError {rc})")
    want = cross_smem(Q, cols, torch.finfo(dtype).bits // 8, lib_name == "psi1_fwd")
    if out[1] != want:
        raise RuntimeError(f"{lib_name} lays out {out[1]} bytes of shared memory, "
                           f"the host counted {want}")
    return out[0]


def cross_launch_splits(lib_name: str, t: torch.Tensor, M: int,
                        waves: int = 1) -> tuple[int, int]:
    """(cols, P) of a cross-covariance launch on t's card, t being mu or X."""
    N, Q = t.shape
    cols = cross_cols(M, Q)
    dev, sms = card_of(t)
    resident = cross_occupancy(lib_name, t.dtype, Q, cols, dev) * sms
    return cols, cross_splits(N, M, Q, resident, waves)


def psi1_plain(mu, S, Z, variance, lengthscale):
    """psi1 (N, M): the same math as the CUDA kernel."""
    return variance * _psi1_weighted(mu, S, mu.new_ones(mu.shape[0]), Z,
                                     lengthscale**2)


def psi1_cuda(mu, S, Z, variance, lengthscale, *, waves: int = 1):
    """psi1 (N, M) from the CUDA kernel, on mu's device and stream, in the
    input dtype; its grid fills `waves` waves of the card (`cross_splits`).
    Raises on inputs the kernel does not take and if the launch fails."""
    global LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi1_cuda",
                 per_point=True, waves=waves)
    N, Q = mu.shape
    M = Z.shape[0]
    cols, P = cross_launch_splits("psi1_fwd", mu, M, waves)
    l2 = (lengthscale * lengthscale).contiguous()
    v = variance.reshape(1).contiguous()
    out = mu.new_empty(N, M)
    launch("psi1_fwd", (mu, S, Z, l2, v, out), (N, M, Q, cols, P))
    LAUNCHES += 1
    return out
