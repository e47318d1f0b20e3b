"""repro_torch: the PyTorch/CUDA port of `repro` (GP models with
parallelization and GPU acceleration).

Mirrors `repro`'s layout module for module so each counterpart is easy to
find; imports `torch` and numpy only, never `jax` or `repro`. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``. Every op
whose JAX counterpart is a Pallas TPU kernel launches a hand-written CUDA
kernel on a CUDA tensor and runs its plain PyTorch version on a CPU tensor.

Ported so far (the serving and training slices): `kernels.ref`,
`kernels.suffstats` (fused psi2 + psiY forward and its reverse pass: plain
versions + CUDA kernels), `kernels.ops` (the differentiable op),
`core.psi_stats`, `core.svgp`, `core.gplvm`, `core.inference`, `optim`
(the reference's Adam), `gp.kernels` (RBF), `gp.stats`, `gp.models`
(`SparseGPRegression`, `BayesianGPLVM`), `serve` (state, online
update/downdate/refit, `GPServer`) and `convert`.
"""
