"""Sharding over a torch `DeviceMesh` (counterpart of `repro.parallel`):
the rules table that places parameters, optimizer state, decode states,
batches and activations (`sharding`), and the collectives the explicit
expert-parallel and GP-head paths run over the mesh's process groups
(`collectives`)."""
