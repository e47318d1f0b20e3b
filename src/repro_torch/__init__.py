"""repro_torch: the PyTorch/CUDA port of `repro` (GP models with
parallelization and GPU acceleration).

Mirrors `repro`'s layout module for module so each counterpart is easy to
find; imports `torch` and numpy only, never `jax` or `repro`. Entry points
run on the CUDA device unless the caller passes ``device="cpu"``. Every op
whose JAX counterpart is a Pallas TPU kernel launches a hand-written CUDA
kernel on a CUDA tensor and runs its plain PyTorch version on a CPU tensor.

Ported so far: `kernels` (the plain oracles, the fused and the
single-statistic ops with their plain versions and CUDA kernels),
`core.psi_stats`, `core.svgp`, `core.gplvm`, `core.inference`,
`core.distributed`, `optim` (the reference's Adam), `gp.kernels` (the
whole family), `gp.stats`, `gp.models` (`SparseGPRegression`,
`BayesianGPLVM`, `regression`), `temporal` (the state-space backend),
`serve` (posterior and temporal states, online update/downdate/refit,
`GPServer`), `data.synthetic` and `convert`.
"""
