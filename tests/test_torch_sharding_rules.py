"""The port's rules table (`repro_torch.parallel.sharding`) against the
reference's (`repro.parallel.sharding`), abstractly: no process group, a
stand-in mesh of axis names and sizes (as tests/test_sharding_rules.py
uses), parameters on the meta device (the reference's through
`jax.eval_shape`).

* The reference file's five tests, on the port's functions.
* For every architecture on the pod and multi-pod meshes, the port's
  `param_specs` equal the reference's leaf by leaf (same paths) and entry
  by entry; the same for `state_specs` on the four architectures the
  reference checks, and for every `ACT_RULES` tag (the spec `constrain`
  redistributes to) at full, lower and non-dividing ranks and shapes.
* The shard each rank holds: in a subprocess with four host devices the
  reference's `NamedSharding.devices_indices_map` on a (2, 2) mesh, and a
  fake process group for each of the port's four ranks on a (2, 2)
  `DeviceMesh`, for every leaf of the smollm smoke config: rank r's local
  tensor is the reference's slice for device r.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_config as jget_config
from repro.models import model_zoo as jzoo
from repro.parallel import sharding as jshd
from repro_torch.configs.base import get_config
from repro_torch.models import model_zoo
from repro_torch.models.attention import head_to_kv_map
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.sharding import Spec

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """Just enough of a mesh for the rules table (axis names + sizes)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


POD = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})
STATE_ARCHS = ["arctic-480b", "rwkv6-7b", "recurrentgemma-2b", "whisper-small"]


def _meta_params(arch):
    return model_zoo.build(get_config(arch)).init(device="meta")


def _check(specs, tree, mesh):
    flat = dict(shd.leaves_with_path(specs, is_leaf=lambda x: isinstance(x, Spec)))
    for path, leaf in shd.leaves_with_path(tree):
        spec = flat[path]
        assert len(spec) in (0, leaf.ndim), (path, spec)
        for dim, ax in zip(leaf.shape, tuple(spec) + (None,) * (leaf.ndim - len(spec))):
            if ax is not None:
                assert dim % shd._axes_size(mesh, ax) == 0, (path, leaf.shape, spec)


@pytest.mark.parametrize("mesh", [POD, MULTI], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_divide_evenly(arch, mesh):
    params = _meta_params(arch)
    _check(shd.param_specs(params, mesh), params, mesh)


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_specs_divide_evenly(arch):
    states = model_zoo.build(get_config(arch)).init_decode_state(128, 32768, device="meta")
    _check(shd.state_specs(states, POD), states, POD)


def test_batch_b1_not_sharded():
    import torch

    specs = shd.batch_specs({"tokens": torch.empty((1, 64), device="meta")}, POD)
    assert specs["tokens"] == Spec(None, None)


def test_sharded_param_fraction_is_high():
    """Catch silent replication: most parameter BYTES must be sharded over
    both axes on the pod mesh."""
    for arch in ("internlm2-20b", "arctic-480b", "rwkv6-7b"):
        params = _meta_params(arch)
        specs = dict(shd.leaves_with_path(shd.param_specs(params, POD),
                                          is_leaf=lambda x: isinstance(x, Spec)))
        total = both = 0
        for path, leaf in shd.leaves_with_path(params):
            total += leaf.numel()
            axes = set()
            for e in specs[path]:
                axes |= {e} if isinstance(e, str) else set(e or ())
            if {"data", "model"} <= axes:
                both += leaf.numel()
        assert both / total > 0.95, (arch, both / total)


def test_vocab_padding_multiple_and_head_padding():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        assert cfg.padded_vocab() % 256 == 0
        assert cfg.padded_vocab() >= cfg.vocab_size
        hp = cfg.padded_heads(16)
        assert hp % 16 == 0 and hp >= cfg.num_heads
        kv_map = head_to_kv_map(cfg, 16)
        assert len(kv_map) == hp
        assert all(0 <= int(k) < cfg.num_kv_heads for k in kv_map)
        G = cfg.num_heads // cfg.num_kv_heads
        assert all(int(kv_map[h]) == h // G for h in range(cfg.num_heads))
    assert get_config("arctic-480b").padded_heads(16) == 64  # 56 -> 64
    assert get_config("smollm-360m").padded_heads(16) == 16  # 15 -> 16, not 80


# ---------------------------------------------------------------------------
# against the reference, entry by entry
# ---------------------------------------------------------------------------

def _ref_specs(specs_tree):
    flat = jax.tree_util.tree_flatten_with_path(specs_tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {jshd._path_str(path): tuple(spec) for path, spec in flat}


def _port_specs(specs_tree):
    return {p: tuple(s) for p, s in
            shd.leaves_with_path(specs_tree, is_leaf=lambda x: isinstance(x, Spec))}


def test_rules_tables_are_the_references():
    assert shd.PARAM_RULES == jshd.PARAM_RULES
    assert shd.STATE_RULES == jshd.STATE_RULES
    assert shd.ACT_RULES == jshd.ACT_RULES
    assert shd.BATCH == jshd.BATCH


@pytest.mark.parametrize("mesh", [POD, MULTI], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_references(arch, mesh):
    jparams = jax.eval_shape(jzoo.build(jget_config(arch)).init, jax.random.PRNGKey(0))
    want = _ref_specs(jshd.param_specs(jparams, mesh))
    got = _port_specs(shd.param_specs(_meta_params(arch), mesh))
    assert got == want


@pytest.mark.parametrize("mesh", [POD, MULTI], ids=["pod", "multipod"])
@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_state_specs_equal_the_references(arch, mesh):
    jstates = jax.eval_shape(lambda: jzoo.build(jget_config(arch)).init_decode_state(128, 32768))
    want = _ref_specs(jshd.state_specs(jstates, mesh))
    states = model_zoo.build(get_config(arch)).init_decode_state(128, 32768, device="meta")
    got = _port_specs(shd.state_specs(states, mesh))
    assert got == want


# a tag at its own rank, at a lower rank (the tail is kept), and with dims
# that the mesh axes do not divide
ACT_SHAPES = [(128, 4096, 960), (256, 64, 16, 128), (2, 8, 32, 512, 64), (4096, 2048),
              (7, 1), (1500, 6, 64), (96,), (64, 3, 3, 5, 5)]


@pytest.mark.parametrize("mesh", [POD, MULTI], ids=["pod", "multipod"])
@pytest.mark.parametrize("tag", sorted(jshd.ACT_RULES))
def test_activation_specs_equal_the_references(tag, mesh):
    constrain, jconstrain = shd.make_constrain(mesh), jshd.make_constrain(mesh)
    assert constrain.tp == jconstrain.tp == 16 and constrain.mesh is mesh
    for shape in ACT_SHAPES:
        if len(shape) > len(jshd.ACT_RULES[tag]):
            continue
        want = tuple(jshd._spec_from_trailing(jshd.ACT_RULES[tag], shape, mesh))
        assert tuple(shd.act_spec(tag, shape, mesh)) == want, (tag, shape)
    assert shd.act_spec("no-such-tag", (4, 4), mesh) is None


def test_placements_follow_the_mesh_order():
    """A dim over two axes is Shard(d) on both mesh dims; an entry naming
    its axes against the mesh's order has no DTensor counterpart."""
    from torch.distributed.tensor import Replicate, Shard

    assert shd.placements(Spec(("pod", "data"), None, "model"), MULTI) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(Spec(None, "data"), MULTI) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="out of mesh order"):
        shd.placements(Spec(("data", "pod")), MULTI)
    one = FakeMesh({"data": 1, "model": 4})  # a split in one part is no split
    assert shd.placements(Spec("data", "model"), one) == (Replicate(), Shard(1))


_SHARDS = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import jax, numpy as np
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro import compat
from repro.parallel import sharding as jshd
from repro_torch.configs.base import get_smoke_config
from repro_torch.models import model_zoo
from repro_torch.parallel import sharding as shd
from repro_torch.launch import mesh as lmesh

cfg = get_smoke_config("smollm-360m")
params = model_zoo.build(cfg).init(0, device="cpu")
# each leaf numbered element by element: a shard names its own positions
leaves = [(p, torch.arange(t.numel(), dtype=torch.float64).reshape(t.shape))
          for p, t in shd.leaves_with_path(params)]
jmesh = compat.make_mesh((2, 2), ("data", "model"))
jparams = jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), params)
jspecs = {{jshd._path_str(k): v for k, v in jax.tree_util.tree_flatten_with_path(
    jshd.param_specs(jparams, jmesh), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}}
want = {{}}
for p, t in leaves:
    idx = jax.sharding.NamedSharding(jmesh, jspecs[p]).devices_indices_map(tuple(t.shape))
    want[p] = {{d.id: t[tuple(idx[d])].flatten().tolist() for d in idx}}
got = {{}}
for rank in range(4):
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
    mesh = lmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    flat = dict(shd.leaves_with_path(shd.to_shardings(shd.param_specs(params, mesh), mesh),
                                     is_leaf=lambda x: isinstance(x, shd.Sharding)))
    for p, t in leaves:
        got.setdefault(p, {{}})[rank] = shd.place(t, flat[p]).to_local().flatten().tolist()
    dist.destroy_process_group()
print(json.dumps({{"want": want, "got": got}}))
"""


def test_each_rank_holds_the_references_shard():
    """Rank r of the port's (2, 2) mesh holds, for every leaf of the smollm
    smoke config, exactly the slice `NamedSharding` gives device r."""
    import repro

    src = str(Path(repro.__file__).resolve().parents[1])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([src, str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", _SHARDS.format(src=src)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(res["got"]) == sorted(res["want"])
    for path, shards in res["want"].items():
        for device, values in shards.items():
            assert res["got"][path][device] == values, (path, device)
