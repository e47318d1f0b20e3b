"""`repro_torch.checkpoint`: the reference's first five checkpoint cases
(round trip, retention, keep_every, async save then wait, shape mismatch)
against the port, every corrupt case, a bfloat16 round trip, async saves
isolated from later in-place updates, and the leaf keys and on-disk format
shared with `repro.checkpoint.manager` in both directions. Round trips are
exact (`torch.equal`); nothing here has a tolerance."""
import json
from pathlib import Path
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JaxManager
from repro_torch.checkpoint import CheckpointCorruptError, CheckpointManager


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 4, generator=g),
        "nested": {"b": torch.arange(6, dtype=torch.int32),
                   "c": torch.ones(3, dtype=torch.bfloat16)},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    mgr.save(3, t, extra={"step": 3, "data": {"seed": 0, "step": 7}})
    restored, extra = mgr.restore(_zeros_like(t), device="cpu")
    _equal(restored, t)
    assert extra == {"step": 3, "data": {"seed": 0, "step": 7}}


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert mgr.steps() == [3, 4]


def test_keep_every_survives_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1, keep_every=2)
    for s in range(5):
        mgr.save(s, _tree(s))
    assert set(mgr.steps()) == {0, 2, 4}


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not list(Path(tmp_path).glob("*.tmp"))  # no tmp dirs left behind


def test_restore_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    bad = {"a": torch.zeros(2, 2),
           "nested": {"b": torch.zeros(6, dtype=torch.int32),
                      "c": torch.zeros(3, dtype=torch.bfloat16)}}
    with pytest.raises(ValueError):
        mgr.restore(bad, device="cpu")
    with pytest.raises(KeyError):
        mgr.restore({"missing": torch.zeros(1)}, device="cpu")


def test_async_save_is_isolated_from_later_updates(tmp_path):
    """The host copy is taken before save() returns: an in-place update
    right after an async save cannot reach the file."""
    mgr = CheckpointManager(tmp_path)
    t = _tree()
    want = t["a"].clone()
    mgr.save(1, t, blocking=False)
    t["a"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(_zeros_like(t), device="cpu")
    assert torch.equal(restored["a"], want)


def test_bfloat16_round_trip(tmp_path):
    """npz has no bfloat16: the leaf is stored widened to float32 with
    "bfloat16" in the manifest, and comes back bitwise equal."""
    g = torch.Generator().manual_seed(1)
    t = {"w": torch.randn(5, 7, generator=g).to(torch.bfloat16)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, t)
    manifest = mgr.load_manifest()
    assert manifest["leaves"]["w"]["dtype"] == "bfloat16"
    arrays, _ = mgr.load_arrays()
    assert arrays["w"].dtype == np.float32
    tensors, _ = mgr.load_tensors(device="cpu")
    assert tensors["w"].dtype == torch.bfloat16 and torch.equal(tensors["w"], t["w"])
    restored, _ = mgr.restore({"w": torch.zeros(5, 7, dtype=torch.bfloat16)}, device="cpu")
    assert torch.equal(restored["w"], t["w"])


# ---------------------------------------------------------------------------
# every corrupt case raises CheckpointCorruptError naming the piece
# ---------------------------------------------------------------------------

def _saved(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    return mgr, tmp_path / "step_1"


def _corrupt(case, d: Path):
    if case == "manifest missing":
        (d / "manifest.json").unlink()
    elif case == "manifest unparseable":
        (d / "manifest.json").write_text("{not json")
    elif case == "no leaves table":
        doc = json.loads((d / "manifest.json").read_text())
        del doc["leaves"]
        (d / "manifest.json").write_text(json.dumps(doc))
    elif case == "npz missing":
        (d / "arrays.npz").unlink()
    elif case == "npz truncated":
        npz = d / "arrays.npz"
        npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 3])
    elif case == "leaf missing":
        arrays = dict(np.load(d / "arrays.npz"))
        del arrays["nested/b"]
        np.savez(d / "arrays.npz", **arrays)
    elif case == "shape mismatch":
        arrays = dict(np.load(d / "arrays.npz"))
        arrays["a"] = np.zeros((3, 3), np.float32)
        np.savez(d / "arrays.npz", **arrays)


@pytest.mark.parametrize("case, match", [
    ("manifest missing", "manifest.json missing"),
    ("manifest unparseable", "does not parse"),
    ("no leaves table", "no leaves table"),
    ("npz missing", "arrays.npz missing"),
    ("npz truncated", "truncated or corrupt"),
    ("leaf missing", "'nested/b' missing"),
    ("shape mismatch", "'a' has shape"),
])
def test_corrupt_checkpoint_rejected(tmp_path, case, match):
    mgr, d = _saved(tmp_path)
    _corrupt(case, d)
    with pytest.raises(CheckpointCorruptError, match=match):
        mgr.load_arrays()
    with pytest.raises(CheckpointCorruptError, match=match):
        mgr.restore(_tree(), device="cpu")


def test_no_checkpoint_is_file_not_found(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).load_manifest()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore(_tree(), device="cpu")


# ---------------------------------------------------------------------------
# the reference's format, both ways
# ---------------------------------------------------------------------------

class _Pair(NamedTuple):
    first: object
    second: object


def _rich(seed=0):
    """Dicts inside a NamedTuple inside a dict, in float64, float32, int32
    and bfloat16 — every flatten rule at once."""
    rng = np.random.default_rng(seed)
    return {"z": _Pair(first={"b": rng.normal(size=(3,)), "a": rng.normal(size=(2, 2))},
                       second=rng.normal(size=(4,)).astype(np.float32)),
            "k": np.arange(5, dtype=np.int32),
            "h": rng.normal(size=(6,)).astype(np.float32)}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*map(_as_torch, tree))
    return torch.as_tensor(tree)


def _as_jax(tree):
    if isinstance(tree, dict):
        return {k: _as_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*map(_as_jax, tree))
    return jnp.asarray(tree)


def test_leaf_keys_match_the_reference(tmp_path):
    tree = _rich()
    JaxManager(tmp_path / "jax").save(1, _as_jax(tree))
    CheckpointManager(tmp_path / "torch").save(1, _as_torch(tree))
    ref = json.loads((tmp_path / "jax/step_1/manifest.json").read_text())["leaves"]
    got = json.loads((tmp_path / "torch/step_1/manifest.json").read_text())["leaves"]
    assert list(got) == list(ref)  # the same keys in the same order
    assert got == ref  # and the same shapes and dtype names


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    tree = _rich(3)
    tree["w"] = np.asarray(np.random.default_rng(4).normal(size=(5,)), np.float32)
    if writer == "jax":
        t = _as_jax(tree)
        t["w"] = t["w"].astype(jnp.bfloat16)
        JaxManager(tmp_path).save(2, t, extra={"who": "jax"})
        restored, extra = CheckpointManager(tmp_path).restore(
            {**_as_torch(tree), "w": torch.zeros(5, dtype=torch.bfloat16)},
            device="cpu")
        want = {**_as_torch(tree), "w": torch.as_tensor(np.asarray(t["w"], np.float32)).to(
            torch.bfloat16)}
        _equal(restored, want)
    else:
        t = {**_as_torch(tree), "w": torch.as_tensor(tree["w"]).to(torch.bfloat16)}
        CheckpointManager(tmp_path).save(2, t, extra={"who": "torch"})
        target = {**_as_jax(tree), "w": jnp.zeros(5, jnp.bfloat16)}
        restored, extra = JaxManager(tmp_path).restore(target)
        for key in ("k", "h"):
            np.testing.assert_array_equal(np.asarray(restored[key]), np.asarray(t[key]))
        np.testing.assert_array_equal(np.asarray(restored["z"].first["a"]),
                                      t["z"].first["a"].numpy())
        np.testing.assert_array_equal(np.asarray(restored["w"], np.float32),
                                      t["w"].float().numpy())
    assert extra == {"who": writer}


@pytest.mark.parametrize("make", [
    lambda: torch.arange(12.).reshape(4, 3).T,  # column-major
    lambda: torch.arange(10.).as_strided((10, 1), (1, 10)),  # a size-1 dim's stride
    lambda: torch.arange(24.).reshape(6, 4)[::2],  # a strided view
    lambda: torch.arange(24.).reshape(2, 3, 4).permute(2, 1, 0),  # 3-D column-major
    lambda: torch.arange(24.).reshape(2, 3, 4).permute(1, 0, 2),  # neither
    lambda: torch.arange(5.),
])
def test_layout_survives_the_round_trip(tmp_path, make):
    """A read gives a leaf the strides `stored_copy` predicts: what numpy
    writes column-major comes back column-major, the rest row-major."""
    from repro_torch.checkpoint.manager import stored_copy

    t = make()
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"t": t})
    back, _ = mgr.load_tensors(device="cpu")
    want = stored_copy(t)
    assert torch.equal(back["t"], t) and torch.equal(want, t)
    assert back["t"].stride() == want.stride()
    assert want.data_ptr() != t.data_ptr()
