"""K_fu, the RBF cross covariance of the sparse GP regression (paper §3):

    K_fu[n, m] = v exp(-1/2 sum_q (x_nq - z_mq)^2 / l_q^2)

(psi1 at S = 0). Counterpart of `repro.kernels.kfu`:

  * `kfu_plain` — the plain PyTorch version, (N, M) at once.
  * `kfu_cuda`  — the wrapper of the hand-written CUDA kernel
    `csrc/kfu_fwd.cu` (replaces the Pallas TPU kernel `kfu_pallas`);
    `LAUNCHES` counts its launches.

Its reverse pass is psi1's at S = 0 (`suffstats.kfu_vjp_plain`,
`suffstats.kfu_bwd_cuda`). CPU tensors run the plain version; the wrapper
takes CUDA tensors only and never falls back to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.psi1 import cross_launch_splits
from repro_torch.kernels.suffstats import check_inputs, launch

# incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0


def kfu_plain(X, Z, variance, lengthscale):
    """K_fu (N, M): the same math as the CUDA kernel, the direct
    (x - z)^2 / l^2 form."""
    b = 1.0 / lengthscale**2
    expo = X.new_zeros(X.shape[0], Z.shape[0])
    for q in range(X.shape[1]):  # Q is small (input dim)
        d = X[:, None, q] - Z[None, :, q]
        expo -= 0.5 * d * d * b[q]
    return variance * torch.exp(expo)


def kfu_cuda(X, Z, variance, lengthscale, *, waves: int = 1):
    """K_fu (N, M) from the CUDA kernel, on X's device and stream, in the
    input dtype; its grid fills `waves` waves of the card (`cross_splits`).
    Raises on inputs the kernel does not take and if the launch fails."""
    global LAUNCHES
    check_inputs(X, None, None, Z, variance, lengthscale, what="kfu_cuda",
                 per_point=True, waves=waves)
    N, Q = X.shape
    M = Z.shape[0]
    cols, P = cross_launch_splits("kfu_fwd", X, M, waves)
    l2 = (lengthscale * lengthscale).contiguous()
    v = variance.reshape(1).contiguous()
    out = X.new_empty(N, M)
    launch("kfu_fwd", (X, Z, l2, v, out), (N, M, Q, cols, P))
    LAUNCHES += 1
    return out
