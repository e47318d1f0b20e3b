"""repro_torch: the PyTorch/CUDA port of `repro` (GP models with
parallelization and GPU acceleration).

Mirrors `repro`'s layout module for module so each counterpart is easy to
find; imports `torch` and numpy only, never `jax` or `repro`. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``. Every op
whose JAX counterpart is a Pallas TPU kernel launches a hand-written CUDA
kernel on a CUDA tensor and runs its plain PyTorch version on a CPU tensor.

Ported so far (the serving slice): `kernels.ref`, `kernels.suffstats`
(fused psi2 + psiY forward: plain version + CUDA kernel), `kernels.ops`,
`core.psi_stats`, `core.svgp`, `gp.kernels` (RBF), `gp.stats`, `serve`
(state, online update/downdate, `GPServer`) and `convert`.
"""
