"""Psi-statistic kernels: plain PyTorch oracles (`ref`), the fused
statistics op (`suffstats`: plain version + hand-written CUDA kernel),
its build/binding (`_build`) and the dispatching op layer (`ops`)."""
