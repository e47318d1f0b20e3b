"""Durable servable-state storage: the serving tier's checkpoint store
(counterpart of `repro.serve.persist`).

A fitted model is (kernel, state) — a `PosteriorState` (collapsed bound,
O(M²)) or a `repro_torch.temporal.TemporalState` (state-space forecaster,
O(d²)), tagged by `state_kind` in the manifest — the state a tree of
tensors, the kernel addressable by registry name. So the store needs no
new format: states ride `repro_torch.checkpoint.CheckpointManager` (atomic
rename, retention, manifest-validated reads) under one sub-directory per
model name, and the kernel travels as a small JSON spec (`kernel_spec` /
`kernel_from_spec`) in the manifest's `extra` alongside a `persist_schema`
version stamp. The layout, leaf keys and `extra` are the reference's, so a
store written by either package loads in the other.

    store = StateStore(path)
    store.save("demand", kernel, state)         # atomic, versioned
    kernel, state = store.load("demand")        # bit-exact round trip

`GPServer(store=..., budget_bytes=...)` uses the same store as the spill
target for LRU eviction and the source for lazy reloads, and
`GPServer.save_all()` / `GPServer.load()` make a kill-and-restart serve
bit-identical predictions.

Corrupt or truncated checkpoints (torn manifest, truncated npz, missing
leaves, wrong schema stamp) raise `CheckpointCorruptError` with the
offending piece named — a restore must never hand back garbage arrays that
would quietly serve garbage predictions.
"""
from __future__ import annotations

import re
import shutil
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointManager,
                                            flatten_with_keys, np_dtype,
                                            stored_copy, unflatten)
from repro_torch.core.psi_stats import SuffStats
from repro_torch.gp import kernels as gp_kernels
from repro_torch.gp.kernels import Kernel
from repro_torch.serve.state import PosteriorState
from repro_torch.temporal.model import TemporalState

# Stamped into every saved manifest's extra; load() rejects mismatches so a
# field added to a state (or a meaning change) can never be silently
# reinterpreted from an old file. Bump when a state schema changes.
# Schema history: 1 = PosteriorState only; 2 = adds `state_kind`
# ("posterior" | "temporal") — schema-1 manifests still load (no
# `state_kind` implies "posterior", the only kind that existed).
PERSIST_SCHEMA = 2
_READABLE_SCHEMAS = (1, 2)
_STATE_KINDS = ("posterior", "temporal")

# model names double as directory names — keep them filesystem-safe
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


# ---------------------------------------------------------------------------
# kernel (de)serialization
# ---------------------------------------------------------------------------

def kernel_spec(kernel: Kernel) -> Dict:
    """JSON-able constructor description that `kernel_from_spec` inverts.

    Kernels are code keyed by registry name — the hyperparameters live in
    the state — so the spec only records the constructor shape: `input_dim`
    for leaf kernels, recursive part specs for Sum/Product.
    """
    parts = getattr(kernel, "parts", None)
    if parts is not None:
        return {"name": kernel.name, "parts": [kernel_spec(p) for p in parts]}
    return {"name": kernel.name, "input_dim": int(kernel.input_dim)}


def kernel_from_spec(spec: Dict) -> Kernel:
    """Rebuild a kernel object from its `kernel_spec` description."""
    if not isinstance(spec, dict) or "name" not in spec:
        raise ValueError(f"malformed kernel spec: {spec!r}")
    cls = gp_kernels.get(spec["name"])  # KeyError lists the registry
    if "parts" in spec:
        return cls(*[kernel_from_spec(p) for p in spec["parts"]])
    return cls(int(spec["input_dim"]))


# ---------------------------------------------------------------------------
# the named store
# ---------------------------------------------------------------------------

def _dict_skeleton(d: Dict) -> Dict:
    """The nesting structure of a param dict with `None` at every leaf —
    JSON-able, and composite kernels (k0/k1/... sub-dicts) round-trip."""
    return {k: _dict_skeleton(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def state_kind(state) -> str:
    """The manifest tag for a servable state's schema."""
    if isinstance(state, TemporalState):
        return "temporal"
    if isinstance(state, PosteriorState):
        return "posterior"
    raise TypeError(
        f"not a servable state: {type(state).__name__} (expected "
        f"PosteriorState or TemporalState)")


def as_stored(state):
    """`state` with every tensor in fresh storage, in the layout the store
    writes and reads back (`checkpoint.manager.stored_copy`: a Cholesky
    factor keeps its column-major strides, a strided view becomes
    contiguous). So a state served before an eviction runs the same ops on
    the same layouts as after its reload, and answers bit for bit the
    same."""
    return unflatten(state, [stored_copy(t) for _, t in flatten_with_keys(state)])


def _skeleton(kern_tree: Dict, kind: str = "posterior"):
    """A structure-only state (of the named kind) whose flatten order (and
    therefore leaf keys) matches the saved state's — dict keys sort
    identically, and NamedTuple fields flatten in declaration order.
    `kern_tree` is the saved `_dict_skeleton` of the kernel params (nested
    for composites)."""
    z = None

    def fill(tree):
        return {k: fill(v) if isinstance(v, dict) else z
                for k, v in tree.items()}

    if kind == "temporal":
        return TemporalState(kern=fill(kern_tree), log_beta=z, t_last=z,
                             m=z, P=z, n=z)
    if kind == "posterior":
        return PosteriorState(kern=fill(kern_tree), Z=z, log_beta=z,
                              stats=SuffStats(z, z, z, z, z),
                              L=z, LA=z, Kuu_inv_mean=z)
    raise CheckpointCorruptError(
        f"unknown state_kind {kind!r}; this build reads {_STATE_KINDS}")


class StateStore:
    """Durable named (kernel, state) store.

    Layout: `<dir>/<name>/step_<k>/` — one CheckpointManager per model, so
    each save is atomic (tmp + rename) and `keep` old versions survive for
    rollback. Thread-safe: one coarse lock serializes store I/O (saves are
    O(M²) bytes — serialization is not the serving hot path).
    """

    def __init__(self, directory: str | Path, *, keep: int = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._managers: Dict[str, CheckpointManager] = {}
        self._lock = threading.Lock()

    def _manager_locked(self, name: str) -> CheckpointManager:
        # caller holds self._lock
        if not _NAME_RE.match(name):
            raise ValueError(
                f"model name {name!r} is not storable: names must match "
                f"{_NAME_RE.pattern} (they double as directory names)")
        if name not in self._managers:
            self._managers[name] = CheckpointManager(self.dir / name,
                                                     keep=self.keep)
        return self._managers[name]

    # -- write ---------------------------------------------------------------

    def save(self, name: str, kernel: Kernel,
             state: "PosteriorState | TemporalState") -> int:
        """Persist one model atomically; returns the step written. Each save
        gets a fresh monotone step so retention keeps `keep` versions."""
        with self._lock:
            mgr = self._manager_locked(name)
            step = (mgr.latest_step() or 0) + 1
            extra = {
                "persist_schema": PERSIST_SCHEMA,
                "state_kind": state_kind(state),
                "kernel": kernel_spec(kernel),
                "kern_tree": _dict_skeleton(state.kern),
            }
            mgr.save(step, state, extra=extra)
            return step

    def delete(self, name: str) -> None:
        with self._lock:
            self._managers.pop(name, None)
            shutil.rmtree(self.dir / name, ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def names(self) -> Tuple[str, ...]:
        """Every model with at least one persisted step."""
        return tuple(sorted(
            p.name for p in self.dir.iterdir()
            if p.is_dir() and any(p.glob("step_*"))))

    def has(self, name: str) -> bool:
        return name in self.names()

    def _extra(self, manifest: Dict, name: str) -> Dict:
        extra = manifest.get("extra") or {}
        schema = extra.get("persist_schema")
        if schema not in _READABLE_SCHEMAS:
            raise CheckpointCorruptError(
                f"model {name!r}: persist_schema is {schema!r}, this build "
                f"reads {_READABLE_SCHEMAS} — refusing to reinterpret the "
                f"state")
        if "kernel" not in extra or "kern_tree" not in extra:
            raise CheckpointCorruptError(
                f"model {name!r}: manifest extra is missing the kernel spec")
        kind = extra.get("state_kind", "posterior")  # schema 1: pre-temporal
        if kind not in _STATE_KINDS:
            raise CheckpointCorruptError(
                f"model {name!r}: unknown state_kind {kind!r}; this build "
                f"reads {_STATE_KINDS}")
        return extra

    def load_meta(self, name: str) -> Tuple[Kernel, Dict]:
        """(kernel, manifest) from the manifest alone — no array I/O. What
        `GPServer.load` uses to register persisted models cold."""
        with self._lock:
            manifest = self._manager_locked(name).load_manifest()
            extra = self._extra(manifest, name)
            return kernel_from_spec(extra["kernel"]), manifest

    def load(self, name: str, *,
             device: str | torch.device = _device.DEFAULT_DEVICE
             ) -> Tuple[Kernel, "PosteriorState | TemporalState"]:
        """Bit-exact restore of (kernel, state), every tensor on `device`
        in the dtype its manifest records. Raises FileNotFoundError if the
        model was never saved, CheckpointCorruptError if its newest
        checkpoint cannot be trusted."""
        with self._lock:
            mgr = self._manager_locked(name)
            tensors, manifest = mgr.load_tensors(device=device)
            extra = self._extra(manifest, name)
            kernel = kernel_from_spec(extra["kernel"])
            skeleton = _skeleton(extra["kern_tree"],
                                 extra.get("state_kind", "posterior"))
            leaves = []
            for key, _ in flatten_with_keys(skeleton):
                if key not in tensors:
                    raise CheckpointCorruptError(
                        f"model {name!r}: checkpoint missing state leaf {key!r}")
                leaves.append(tensors[key])
            return kernel, unflatten(skeleton, leaves)

    def nbytes(self, name: str) -> int:
        """Resident size of the stored state, from the manifest alone (no
        array I/O) — what the server's LRU accountant charges a cold entry."""
        with self._lock:
            manifest = self._manager_locked(name).load_manifest()
            self._extra(manifest, name)
            return int(sum(
                int(np.prod(meta["shape"])) * _itemsize(meta["dtype"])
                for meta in manifest["leaves"].values()))


def _itemsize(name: str) -> int:
    """Resident bytes of one element of a manifest dtype (bfloat16: 2, not
    its widened float32's 4)."""
    return 2 if name == "bfloat16" else np_dtype(name).itemsize
