"""Checkpointing with retention, atomicity and async save (counterpart of
`repro.checkpoint.manager`).

Layout per step:  <dir>/step_<N>/
    manifest.json   — step, leaf keys, shapes, dtypes, extra state, save
                      timestamp
    arrays.npz      — one entry per leaf of the tree (key-addressed)

A tree is nested dicts, `NamedTuple`s, lists and tuples of tensors (or
numpy arrays). Leaves are keyed and ordered as the reference orders a
pytree: dict keys sorted, `NamedTuple` fields in declaration order with a
leading "." (".kern/log_lengthscale", ".stats/.psi2"), sequence items by
index. So the two packages write the same keys, and each reads the other's
checkpoints. The manifest's "treedef" is a plain description of the tree
(the reference writes a JAX `PyTreeDef` string there); neither package
reads it back.

Guarantees:
  * atomic: written to step_<N>.tmp then os.rename'd — a crash mid-save
    never corrupts the latest checkpoint;
  * retention: keep the newest `keep` checkpoints (+ every `keep_every`-th);
  * async: `save(..., blocking=False)` copies every leaf to the host first,
    synchronously, and hands only that copy to a writer thread, so a later
    in-place update of a tensor on the card cannot race the write; `wait()`
    joins the thread;
  * validated reads: every corrupt piece raises `CheckpointCorruptError`;
  * layout: a leaf is written in its own dense layout (row- or, for a 2-D
    leaf, column-major; a strided view as its dense copy) and read back
    with it. Matrix products on the card can take another path, and so
    round differently, for another layout, so a restored Cholesky factor
    keeps its column-major strides.

bfloat16 leaves are stored widened to float32 (npz has no bfloat16; f32 ⊃
bf16, so the round trip is exact) and the manifest keeps "bfloat16";
reads cast them back.

On a device mesh. Checkpoints hold full tensors, whatever the mesh: `save`
gathers each DTensor leaf (`full_tensor()`, a collective every rank of
its mesh joins) and rank 0 writes; a blocking save ends with a barrier
over the mesh, so no rank reads before the write is down. `restore(...,
shardings=)` places each leaf by the current mesh's placements
(`parallel.sharding.Sharding`), every rank reading the whole leaf and
keeping its own slices: resuming on another mesh is re-placement, not a
resharding of shard files (`runtime.elastic`).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.parallel import sharding as shd

Tree = Any

# dtype names numpy does not know, stored widened to float32
_WIDENED = {"bfloat16": torch.bfloat16}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint directory that exists but cannot be trusted: manifest
    that does not parse, arrays file missing or truncated, or arrays that
    disagree with the manifest's declared shapes. Raised instead of handing
    back garbage leaves — a torn restore must fail loudly."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key part, child) of a container in the reference's flatten order,
    or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def leaf_key(path) -> str:
    """The manifest/npz key of one leaf from its path of key parts — shared
    by save and every restore path so the two can never drift."""
    return "/".join(path)


def flatten_with_keys(tree: Tree) -> List[Tuple[str, Any]]:
    """(key, leaf) of every leaf in flatten order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        items = _items(node)
        if items is None:
            out.append((leaf_key(path), node))
            return
        for part, child in items:
            walk(child, path + [part])

    walk(tree, [])
    return out


def unflatten(skeleton: Tree, leaves: List[Any]) -> Tree:
    """`skeleton`'s structure with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            rebuilt = {k: build(node[k]) for k in sorted(node)}
            return {k: rebuilt[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, f)) for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(skeleton)


def _describe(tree) -> str:
    """A plain description of the tree's structure for the manifest."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(_describe(getattr(tree, f)) for f in tree._fields) + ")")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    return "*"


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a manifest dtype name is stored as (bfloat16: the
    widened float32)."""
    return np.dtype(np.float32) if name in _WIDENED else np.dtype(name)


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a manifest dtype name (numpy's names are
    torch's)."""
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointCorruptError(f"unknown leaf dtype {name!r}")
    return dtype


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(host copy as stored, manifest dtype name) of one leaf (a DTensor
    gathered whole first)."""
    if isinstance(leaf, torch.Tensor):
        t = shd.full(leaf.detach())
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype in _WIDENED.values():
            t = t.to(torch.float32)
        # a copy, so a later in-place update cannot reach the write, in the
        # tensor's own dense layout: npz keeps a column-major (2-D) array
        # column-major, and the read gives those strides back
        return np.array(t.cpu().numpy(), order="K"), name
    arr = np.array(leaf, order="K")
    return arr, arr.dtype.name


def stored_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` in fresh storage with the strides a save and a read
    give it: column-major where numpy stores it column-major (F- but not
    C-contiguous), row-major otherwise — canonical strides either way."""
    t = t.detach()
    rev = tuple(reversed(range(t.dim())))
    if t.dim() > 1 and not t.is_contiguous() and t.permute(rev).is_contiguous():
        out = t.new_empty(tuple(reversed(t.shape))).permute(rev)
    else:
        out = t.new_empty(t.shape)
    return out.copy_(t)


def _flatten(tree: Tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    arrays, names = {}, {}
    for key, leaf in flatten_with_keys(tree):
        arrays[key], names[key] = _host(leaf)
    return arrays, names


class CheckpointManager:
    """Numbered checkpoints of one tree under `directory` (see the module
    docstring for layout and guarantees)."""

    def __init__(self, directory: str | Path, *, keep: int = 3, keep_every: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_every = keep_every
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Tree, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Write `tree` as step `step`. The host copy is taken here,
        synchronously, even with blocking=False."""
        mesh = next((x.device_mesh for _, x in flatten_with_keys(tree) if shd.is_dtensor(x)),
                    None)
        flat, names = _flatten(tree)
        # on a mesh, its first rank writes the gathered tensors
        writer = mesh is None or dist.get_rank() == int(mesh.mesh.flatten()[0])
        manifest = {
            "step": step,
            "time": time.time(),
            "extra": extra or {},
            "treedef": _describe(tree),
            "leaves": {k: {"shape": list(v.shape), "dtype": names[k]}
                       for k, v in flat.items()},
        }

        def write():
            tmp = self.dir / f"step_{step}.tmp"
            final = self.dir / f"step_{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **flat)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._retain()

        self.wait()
        if blocking:
            if writer:
                write()
            if mesh is not None:
                shd.mesh_barrier(mesh)
        elif writer:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*") if not p.suffix
        )

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _retain(self) -> None:
        steps = self.steps()
        doomed = steps[: -self.keep] if self.keep else []
        for s in doomed:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def load_manifest(self, step: Optional[int] = None) -> Dict:
        """The validated manifest of a step: must exist, parse as JSON, and
        carry a leaves table. Raises CheckpointCorruptError otherwise —
        cheap enough to call for metadata alone (no array I/O)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except FileNotFoundError:
            raise CheckpointCorruptError(f"{d}: manifest.json missing") from None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CheckpointCorruptError(
                f"{d}/manifest.json does not parse as JSON ({e})") from None
        if not isinstance(manifest, dict) or not isinstance(manifest.get("leaves"), dict):
            raise CheckpointCorruptError(
                f"{d}/manifest.json carries no leaves table")
        return manifest

    def load_arrays(self, step: Optional[int] = None
                    ) -> tuple[Dict[str, np.ndarray], Dict]:
        """Validated raw read: (key-addressed numpy leaves as stored,
        manifest).

        Every failure mode of a torn or corrupt checkpoint — unparseable
        manifest, missing/truncated arrays.npz, leaves absent from the
        archive, shapes disagreeing with the manifest — raises
        CheckpointCorruptError naming the offending piece. Widened leaves
        (bfloat16) stay float32 here; `torch_dtype` of their manifest name
        gives the true dtype."""
        step = step if step is not None else self.latest_step()
        manifest = self.load_manifest(step)
        d = self.dir / f"step_{step}"
        try:
            with np.load(d / "arrays.npz", allow_pickle=False) as npz:
                arrays = {k: npz[k] for k in npz.files}
        except FileNotFoundError:
            raise CheckpointCorruptError(f"{d}: arrays.npz missing") from None
        except Exception as e:  # noqa: BLE001 — any unreadable archive is corrupt
            raise CheckpointCorruptError(
                f"{d}/arrays.npz unreadable — truncated or corrupt ({e})"
            ) from None
        out = {}
        for key, meta in manifest["leaves"].items():
            if key not in arrays:
                raise CheckpointCorruptError(
                    f"{d}: leaf {key!r} missing from arrays.npz")
            arr = arrays[key]
            if list(arr.shape) != list(meta["shape"]):
                raise CheckpointCorruptError(
                    f"{d}: leaf {key!r} has shape {list(arr.shape)}, manifest "
                    f"declares {meta['shape']}")
            dtype = np_dtype(meta["dtype"])
            if arr.dtype != dtype:
                arr = arr.astype(dtype)
            out[key] = arr
        return out, manifest

    def load_tensors(self, step: Optional[int] = None, *,
                     device: str | torch.device = _device.DEFAULT_DEVICE
                     ) -> tuple[Dict[str, torch.Tensor], Dict]:
        """`load_arrays` as tensors on `device`, each in its manifest dtype
        (bfloat16 cast back)."""
        dev = _device.resolve(device)
        arrays, manifest = self.load_arrays(step)
        return {k: torch.from_numpy(a).to(device=dev, dtype=torch_dtype(
                    manifest["leaves"][k]["dtype"]))
                for k, a in arrays.items()}, manifest

    def restore(self, target: Tree, step: Optional[int] = None, *,
                device: str | torch.device = _device.DEFAULT_DEVICE,
                shardings: Optional[Tree] = None) -> tuple[Tree, Dict]:
        """Restore into the structure of `target`, each leaf on `device` in
        its target leaf's dtype; returns (tree, extra). `shardings` (the
        target's structure, `sharding.Sharding` leaves or None) places each
        leaf on its mesh: pass the current mesh's shardings to resume on
        another topology."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        tensors, manifest = self.load_tensors(step, device=device)
        placed = dict(flatten_with_keys(shardings)) if shardings is not None else {}
        leaves = []
        for key, leaf in flatten_with_keys(target):
            if key not in tensors:
                raise KeyError(f"checkpoint step {step} missing leaf {key}")
            t = tensors[key]
            shape = tuple(np.shape(leaf))
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}: checkpoint {tuple(t.shape)} != target {shape}")
            dtype = leaf.dtype if isinstance(leaf, torch.Tensor) else \
                torch_dtype(np.asarray(leaf).dtype.name)
            leaves.append(shd.place(t.to(dtype), placed.get(key)))
        return unflatten(target, leaves), manifest["extra"]
