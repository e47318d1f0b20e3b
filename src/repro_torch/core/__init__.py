"""Sufficient statistics (`psi_stats`) and the collapsed-bound epilogue
(`svgp`) of the sparse GP, in PyTorch."""
