"""The psi2 statistic alone (paper §3, Table 1's "Phi" accumulation):

    psi2[m, m'] = v^2 exp(-|z_m - z_m'|^2 / 4 l^2)
                  sum_n prod_q (1 + 2 S_nq / l_q^2)^(-1/2)
                        exp(-(mu_nq - zbar_q)^2 / (l_q^2 + 2 S_nq))

Counterpart of `repro.kernels.psi2`:

  * `psi2_plain` — the plain PyTorch version: a chunked loop over N,
    O(chunk * M^2) live, the (m, m')-only prefactor applied outside the sum.
  * `psi2_cuda`  — the wrapper of the hand-written CUDA kernel
    `csrc/psi2_fwd.cu` (replaces the Pallas TPU kernel `psi2_pallas`);
    `LAUNCHES` counts its launches.

CPU tensors run the plain version; the wrapper takes CUDA tensors only and
never falls back to the plain version.
"""
from __future__ import annotations

from repro_torch.kernels.suffstats import (_chunks, _psi2_prefactor,
                                           _psi2_weighted, check_inputs, launch,
                                           splits)

# incremented once per launch of the CUDA kernel, and nowhere else
LAUNCHES = 0


def psi2_plain(mu, S, Z, variance, lengthscale, *, chunk: int = 1024):
    """psi2 (M, M) by one streaming pass over N in chunks of `chunk`
    datapoints: the same math as the CUDA kernel."""
    M = Z.shape[0]
    l2 = lengthscale**2
    zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    acc = mu.new_zeros(M, M)
    for sl in _chunks(mu.shape[0], chunk):
        mu_i = mu[sl]
        acc = acc + _psi2_weighted(mu_i, S[sl], mu_i.new_ones(mu_i.shape[0]),
                                   zbar, l2).sum(0)
    return _psi2_prefactor(Z, variance, lengthscale) * acc


def psi2_cuda(mu, S, Z, variance, lengthscale):
    """psi2 (M, M) from the CUDA kernel, on mu's device and stream, in the
    input dtype. Raises on inputs the kernel does not take and if the launch
    fails."""
    global LAUNCHES
    check_inputs(mu, S, None, Z, variance, lengthscale, what="psi2_cuda")
    N, Q = mu.shape
    M = Z.shape[0]
    P = splits(N, M, 1)[0]
    l2 = (lengthscale * lengthscale).contiguous()
    part, acc = mu.new_empty(P, M, M), mu.new_empty(M, M)
    launch("psi2_fwd", (mu, S, Z, l2, part, acc), (N, M, Q, P))
    LAUNCHES += 1
    return _psi2_prefactor(Z, variance, lengthscale) * acc
