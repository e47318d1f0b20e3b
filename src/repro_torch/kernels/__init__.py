"""Psi-statistic kernels: plain PyTorch oracles (`ref`), the fused
statistics op (`suffstats`: plain version + hand-written CUDA kernel, and
the single-statistic reverse passes), K_fu, psi1 and psi2 alone (`kfu`,
`psi1`, `psi2`: plain version + hand-written CUDA kernel each), their build
and binding (`_build`) and the dispatching op layer (`ops`)."""
