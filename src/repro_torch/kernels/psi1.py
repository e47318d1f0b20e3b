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

from repro_torch.kernels.suffstats import _psi1_weighted, check_inputs, launch

# incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0
# the kernel stages at most this many elements of Z per block (cols * Q)
Z_TILE_ELEMS = 2048


def psi1_plain(mu, S, Z, variance, lengthscale):
    """psi1 (N, M): the same math as the CUDA kernel."""
    return variance * _psi1_weighted(mu, S, mu.new_ones(mu.shape[0]), Z,
                                     lengthscale**2)


def psi1_cuda(mu, S, Z, variance, lengthscale):
    """psi1 (N, M) from the CUDA kernel, on mu's device and stream, in the
    input dtype. Raises on inputs the kernel does not take and if the launch
    fails."""
    global LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi1_cuda",
                 per_point=True)
    N, Q = mu.shape
    M = Z.shape[0]
    cols = min(M, Z_TILE_ELEMS // Q)
    l2 = (lengthscale * lengthscale).contiguous()
    v = variance.reshape(1).contiguous()
    out = mu.new_empty(N, M)
    launch("psi1_fwd", (mu, S, Z, l2, v, out), (N, M, Q, cols))
    LAUNCHES += 1
    return out
