"""The LM dry run (`repro_torch.launch.dryrun`) against the reference's
(`repro.launch.dryrun`): the parameter and model-flop counts, the cells it
skips, each rank's argument and output bytes against XLA's
`memory_analysis()`, the op counter on programs whose counts are known,
the layer loops counted once and multiplied against whole traces, the
matrix-product flops against `FlopCounterMode` on a real step, the three
model sites that once failed to trace, and the CLI.

A fake process group lives only in subprocesses (`_PORT`), so no test of
another file shares a process with one; the reference's compiled steps
run on four host devices in a subprocess (`_REFERENCE`), all at once.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import roofline as jroofline
from repro.models import model_zoo as jzoo
from repro_torch.configs.base import ARCH_IDS, SHAPES, ShapeCell, cell_applicable, get_config
from repro_torch.configs.base import get_smoke_config
from repro_torch.launch import cost, roofline, steps
from repro_torch.launch import mesh as lmesh
from repro_torch.models import model_zoo

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
TIMEOUT_S = 600
CELL = (32, 4)  # sequence, batch of the smoke steps
MEM_ARCHS = ("smollm-360m", "moonshot-v1-16b-a3b")  # dense and the MoE smoke configs
KINDS = ("train", "prefill", "decode")
LOOP_ARCHS = ("smollm-360m", "recurrentgemma-2b", "whisper-small")  # dense, hybrid, enc-dec
PERIODS = (2, 4)  # whole periods of each layer pattern; 4 leaves two repeats stood in for

# the reference's record keys (src/repro/launch/dryrun.py:46-117)
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "seq_len", "global_batch", "status", "n_chips",
               "lower_s", "compile_s", "memory", "flops_per_chip", "bytes_per_chip",
               "xla_flops_scan_once", "xla_bytes_scan_once", "collectives", "roofline",
               "model_flops", "useful_compute_fraction", "n_params_total"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_hbm_bytes_est"}
COLLECTIVE_KEYS = {"counts", "raw_bytes_per_chip", "traffic_bytes_per_chip"}
ROOFLINE_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "step_lower_bound_s", "compute_fraction_of_bound"}


def _env(*paths) -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "PYTHONPATH": os.pathsep.join(str(p) for p in paths)}


_REFERENCE = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro import compat
from repro.configs.base import get_smoke_config, ShapeCell
from repro.launch.steps import make_step
mesh = compat.make_mesh((2, 2), ("data", "model"))
out = {}
for arch in %(archs)r:
    for kind in %(kinds)r:
        with mesh:
            b = make_step(kind, get_smoke_config(arch), ShapeCell("s", %(S)d, %(B)d, kind), mesh)
            ma = b.lower().compile().memory_analysis()
        out[arch + "/" + kind] = [ma.argument_size_in_bytes, ma.output_size_in_bytes]
print(json.dumps(out))
"""

_PORT = r"""
import dataclasses, json, sys
import torch, torch.distributed as dist
from repro_torch.configs.base import ShapeCell, get_smoke_config
from repro_torch.launch import cost, dryrun, steps
from repro_torch.launch import mesh as lmesh
from repro_torch.parallel import collectives
from repro_torch.parallel import sharding as shd

part, S, B = sys.argv[1], %(S)d, %(B)d
out = {}


def mesh22(device="cuda"):
    dryrun.open_fake_group(4)
    return lmesh.make_mesh((2, 2), ("data", "model"), device)


def leaves(tree):
    return len(shd.leaves_with_path(tree))


if part == "memory":
    mesh = mesh22()
    for arch in %(archs)r:
        for kind in %(kinds)r:
            b = steps.make_step(kind, get_smoke_config(arch), ShapeCell("s", S, B, kind), mesh)
            low = b.lower()
            out[arch + "/" + kind] = dict(low.memory, n_out=leaves(b.out_shardings))
elif part == "counter":
    from torch.distributed.tensor import Partial, Replicate, Shard
    for P in (2, 4):
        dryrun.open_fake_group(P)
        mesh = lmesh.make_mesh((P,), ("model",), "cuda")
        res = {}

        def count(fn):
            c = cost.OpCounter()
            with cost.counting(c):
                fn()
            return c.total.as_dict()

        a = shd.meta_shard((64, 128), torch.float32, mesh, (Shard(1),))
        w = shd.meta_shard((128, 32), torch.float32, mesh, (Shard(0),))
        res["matmul"] = count(lambda: a @ w)
        x = shd.meta_shard((8, 16), torch.float32, mesh, (Shard(0),))
        res["gather"] = count(lambda: x.redistribute(mesh, (Replicate(),)))
        y = shd.meta_shard((8, 16), torch.float32, mesh, (Partial(),))
        res["reduce"] = count(lambda: y.redistribute(mesh, (Replicate(),)))
        res["a2a"] = count(lambda: x.redistribute(mesh, (Shard(1),)))
        g = mesh.get_group(0)
        t = torch.empty((P, 4, 16), device="meta")
        res["c10d_a2a"] = count(lambda: collectives.all_to_all(t, g))
        r = torch.empty((8, 16), device="meta")
        res["c10d_all_reduce"] = count(lambda: dist.all_reduce(r, group=g))
        out[P] = res
elif part == "sites":
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh = mesh22("cpu")  # fake tensors of the CPU: placed on a CUDA mesh they would move
    for arch, kind in (("smollm-360m", "prefill"), ("smollm-360m", "decode"),
                       ("moonshot-v1-16b-a3b", "train")):
        b = steps.make_step(kind, get_smoke_config(arch), ShapeCell("s", S, B, kind), mesh)
        with FakeTensorMode(allow_non_fake_inputs=True):
            args = []
            for a, sh in zip(b.abstract_args, b.in_shardings):
                is_sh = lambda x: isinstance(x, shd.Sharding)  # noqa: E731
                flat = None if is_sh(sh) else dict(shd.leaves_with_path(sh, is_leaf=is_sh))

                def one(p, t, sh=sh, flat=flat):
                    s_ = sh if flat is None else flat[p]
                    f = torch.empty(tuple(t.shape), dtype=t.dtype, device="cpu")
                    return shd.place(f, s_)

                args.append(shd.map_with_path(one, a))
            res = b.jitted()(*args)
        out[arch + "/" + kind] = type(shd.leaves_with_path(res)[0][1]).__name__
else:  # the layer loops: multiplied against whole traces
    mesh = mesh22()
    arch = part
    for periods in %(periods)r:
        cfg = get_smoke_config(arch)
        period = max(len(cfg.window_pattern), len(cfg.mixer_pattern))
        cfg = dataclasses.replace(cfg, num_layers=period * periods, remat=True,
                                  encoder_layers=periods if cfg.encoder_layers else 0)
        for kind in %(kinds)r:
            got = {}
            for multiply in (True, False):
                b = steps.make_step(kind, cfg, ShapeCell("s", S, B, kind), mesh)
                low = b.lower(multiply=multiply)
                got[multiply] = [low.total.as_dict(), low.once.flops, low.memory]
            out[f"{periods}/{kind}"] = got
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """Every subprocess at once: the reference's memory analyses, and the
    port's memory, counter, sites and layer-loop parts."""
    import repro

    jsrc = Path(repro.__file__).resolve().parents[1]
    fmt = {"archs": MEM_ARCHS, "kinds": KINDS, "S": CELL[0], "B": CELL[1], "periods": PERIODS}
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % fmt], env=_env(jsrc), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for part in ("memory", "counter", "sites") + LOOP_ARCHS:
        procs[part] = subprocess.Popen(
            [sys.executable, "-c", _PORT % fmt, part], env=_env(SRC), cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
        assert proc.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


# ---------------------------------------------------------------------------
# parameter and model-flop counts, skipped cells
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _jparams(arch: str):
    model = jzoo.build(jbase.get_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@lru_cache(maxsize=None)
def _params(arch: str):
    return model_zoo.build(get_config(arch)).init(device="meta")


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_model_flop_counts_equal_the_references(arch, shape):
    """Full width, from the reference's `eval_shape` tree and the port's
    meta tree: the same parameter count, and MODEL_FLOPS with the same path
    rules (embeddings out, MoE experts at top-k / E) for the cell's tokens."""
    cell = SHAPES[shape]
    n_tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    jp, p = _jparams(arch), _params(arch)
    assert roofline.count_params(p) == jroofline.count_params(jp)
    want = jroofline.model_flops(jbase.get_config(arch), jp, n_tokens)
    got = roofline.model_flops(get_config(arch), p, n_tokens)
    assert got == want


def test_the_skipped_cells_are_the_references():
    """The same cells skip, for the same reason (the reference's ends with
    a pointer to its design notes, which the port does not carry)."""
    got = {(a, s): cell_applicable(get_config(a), SHAPES[s]) for a in ARCH_IDS for s in SHAPES}
    want = {(a, s): jbase.cell_applicable(jbase.get_config(a), jbase.SHAPES[s])
            for a in ARCH_IDS for s in SHAPES}
    assert {k: ok for k, (ok, _) in got.items()} == {k: ok for k, (ok, _) in want.items()}
    assert all(want[k][1].startswith(why) for k, (_, why) in got.items())
    assert sum(not ok for ok, _ in got.values()) == 8  # long_500k of the full-attention archs


# ---------------------------------------------------------------------------
# each rank's bytes against XLA's memory analysis on a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", MEM_ARCHS)
def test_argument_and_output_bytes_equal_the_references(runs, arch, kind):
    """Rank 0's argument bytes equal the reference's per-device argument
    size exactly: every leaf is the same shard (`test_torch_sharding_rules`)
    of the same dtype. XLA's output size counts, besides the same shards,
    the result tuple's index table, one 8-byte pointer a leaf, which an
    eager step does not allocate: the output bytes are the reference's less
    8 bytes a result leaf."""
    got, want = runs["memory"][f"{arch}/{kind}"], runs["reference"][f"{arch}/{kind}"]
    assert got["argument_bytes"] == want[0]
    assert got["output_bytes"] == want[1] - 8 * got["n_out"]
    # decode's states advance in place (the reference donates them): they
    # alias; train and prefill return new tensors
    states = got["alias_bytes"]
    assert (states > 0) == (kind == "decode")
    assert got["peak_hbm_bytes_est"] == (got["argument_bytes"] + got["output_bytes"]
                                         - got["alias_bytes"] + got["temp_bytes"])


# ---------------------------------------------------------------------------
# the counter on programs whose counts are known
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 4])
def test_a_sharded_product_counts_the_ranks_local_flops_once(runs, P):
    """(64, 128) @ (128, 32) with the contraction split over P ranks: each
    rank's local product, 2 * 64 * 32 * 128 / P, and nothing at the global
    shape; the result stays a partial sum (no collective)."""
    got = runs["counter"][str(P)]["matmul"]
    assert got["matmul_flops"] == {"float32": 2.0 * 64 * 32 * 128 / P}
    assert got["other_flops"] == {} and got["collectives"]["counts"] == {}


@pytest.mark.parametrize("P", [2, 4])
def test_redistributions_count_the_ring_traffic(runs, P):
    """An (8, 16) float32 tensor (512 bytes) over P ranks of one node:
    Shard -> Replicate is an all-gather of the 512-byte result, (P - 1)/P of
    it through each rank; Partial -> Replicate an all-reduce of the local
    512 bytes, twice (P - 1)/P of it; Shard(0) -> Shard(1) an all-to-all of
    the 512/P-byte result, (P - 1)/P of it."""
    r = runs["counter"][str(P)]
    frac = (P - 1) / P
    cases = {"gather": ("all-gather", 512, 512 * frac),
             "reduce": ("all-reduce", 512, 2 * 512 * frac),
             "a2a": ("all-to-all", 512 / P, 512 / P * frac),
             # parallel.collectives' own calls: all_to_all_single on (P, 4, 16),
             # all_reduce of (8, 16) in place
             "c10d_a2a": ("all-to-all", P * 4 * 16 * 4, P * 4 * 16 * 4 * frac),
             "c10d_all_reduce": ("all-reduce", 512, 2 * 512 * frac)}
    for case, (kind, raw, traffic) in cases.items():
        coll = r[case]["collectives"]
        assert coll["counts"] == {kind: 1.0}, case
        assert coll["raw_bytes_per_chip"] == {kind: raw}, case
        assert coll["traffic_bytes_per_chip"] == pytest.approx(traffic, rel=1e-12), case
        assert set(coll["traffic_by_link"]) == {"nvlink"}, case


def test_groups_across_nodes_take_the_network_rate():
    """Ranks fill nodes of 8 in order: a group inside one node runs at
    NVLink's rate, one spanning two at the network's."""
    assert roofline.link_of(range(8)) == "nvlink"
    assert roofline.link_of([0, 16]) == "network"
    assert roofline.link_of(range(0, 256, 16)) == "network"
    t = roofline.lm_roofline_terms({}, {}, 0.0, {"nvlink": 450e9, "network": 50e9})
    assert t["t_collective_s"] == pytest.approx(2.0)
    # a bf16 product at the tensor cores' rate, float32 at the SIMT rate
    t = roofline.lm_roofline_terms({"bfloat16": 989.4e12, "float32": 67e12},
                                   {"float64": 34e12}, 0.0, {})
    assert t["t_matmul_s"] == pytest.approx(2.0) and t["t_other_s"] == pytest.approx(1.0)
    assert t["dominant"] == "compute" and t["step_lower_bound_s"] == pytest.approx(3.0)


# ---------------------------------------------------------------------------
# layer loops counted once and multiplied, against whole traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periods", PERIODS)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", LOOP_ARCHS)
def test_multiplied_layer_loops_equal_whole_traces(runs, arch, kind, periods):
    """On a fake (2, 2) mesh, remat on: the flops (by dtype, products and
    the rest), bytes and collectives (kind, count, bytes, ring traffic) of
    the step with each layer loop traced at its first and last repeat and
    the last counted for every later one equal the whole trace's exactly;
    the body counted once is less where repeats were stood in for; the
    reconstructed peak within 1 % of the whole trace's, or 32 of the
    allocator's 512-byte blocks at these toy sizes."""
    multiplied, whole = runs[arch][f"{periods}/{kind}"]["true"], \
        runs[arch][f"{periods}/{kind}"]["false"]
    assert multiplied[0] == whole[0]
    if periods > 2:
        assert multiplied[1] < whole[1]
    peak_m, peak_w = multiplied[2]["peak_hbm_bytes_est"], whole[2]["peak_hbm_bytes_est"]
    assert abs(peak_m - peak_w) <= max(0.01 * peak_w, 32 * 512)


def test_one_rank_matmul_flops_equal_flop_counter_mode_on_the_real_step():
    """The smoke train step on one rank: the counter's matrix-product flops
    (traced on meta tensors, layer loops multiplied) equal FlopCounterMode's
    on the real step on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = get_smoke_config("smollm-360m")
    cell = ShapeCell("s", *CELL, "train")
    bundle = steps.make_train_step(cfg, cell, lmesh.make_host_mesh("cpu"))
    low = bundle.lower()
    params = model_zoo.build(cfg).init(0, device="cpu")
    from repro_torch.optim import adam_init

    args = (params, adam_init(params, steps.default_adam(cfg)),
            model_zoo.make_batch(torch.Generator().manual_seed(0), cfg, cell))
    with FlopCounterMode(display=False) as fc:
        bundle.jitted()(*args)
    assert sum(low.total.matmul_flops.values()) == fc.get_total_flops()
    assert low.compile_s is None and low.lower_s > 0 and low.n_ranks == 1


# ---------------------------------------------------------------------------
# the three sites rewritten in a static form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", ["smollm-360m/prefill", "smollm-360m/decode",
                                  "moonshot-v1-16b-a3b/train"])
def test_rewritten_sites_trace_under_fake_tensor_mode(runs, site):
    """prefill's cache fill (`attention._fill_sharded`, once a nonzero),
    decode's slot write (`attention._decode_sharded`, once an in-place
    write indexed by a DTensor) and MoE's load count (`moe._route`, once a
    bincount) run on fake DTensors on a fake (2, 2) mesh: each step
    returns DTensors of fake tensors."""
    assert runs["sites"][site] == "DTensor"


# ---------------------------------------------------------------------------
# the CLI, StepBundle.lower, and the private APIs leaned on
# ---------------------------------------------------------------------------

def test_cli_writes_the_references_record_keys(tmp_path):
    """A cheap production cell (smollm-360m decode_32k on the pod mesh) and
    a skipped one; a second run reads its cache."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "smollm-360m",
           "--shape", "decode_32k", "--mesh", "pod", "--out", str(tmp_path)]
    out = subprocess.run(cmd + ["--force"], env=_env(SRC), cwd=ROOT, capture_output=True,
                         text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads((tmp_path / "smollm-360m_decode_32k_pod.json").read_text())
    assert rec["status"] == "ok" and RECORD_KEYS <= set(rec)
    assert MEMORY_KEYS <= set(rec["memory"]) and COLLECTIVE_KEYS <= set(rec["collectives"])
    assert ROOFLINE_KEYS <= set(rec["roofline"]) and rec["n_chips"] == 256
    assert rec["compile_s"] is None and 0 < rec["useful_compute_fraction"] <= 1
    again = subprocess.run(cmd, env=_env(SRC), cwd=ROOT, capture_output=True, text=True,
                           timeout=TIMEOUT_S)
    assert again.returncode == 0 and "[cached]" in again.stdout
    skip = subprocess.run(cmd[:6] + ["long_500k"] + cmd[7:], env=_env(SRC), cwd=ROOT,
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert skip.returncode == 0
    rec = json.loads((tmp_path / "smollm-360m_long_500k_pod.json").read_text())
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


_ERRING = r"""
import sys
from repro_torch.launch import dryrun, steps

def broken(*a, **k):
    raise RuntimeError("no step here")

steps.make_step = broken
sys.exit(dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh", "pod",
                      "--force", "--out", sys.argv[1]]))
"""


def test_an_erring_cell_is_recorded_and_exits_1(tmp_path):
    out = subprocess.run([sys.executable, "-c", _ERRING, str(tmp_path)], env=_env(SRC),
                         cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 1, out.stderr[-3000:]
    rec = json.loads((tmp_path / "smollm-360m_decode_32k_pod.json").read_text())
    assert rec["status"] == "error" and "no step here" in rec["error"]
    assert "[FAIL]" in out.stdout and "1 failures" in out.stdout


@pytest.mark.parametrize("kind", KINDS)
def test_step_bundle_lower_on_one_rank(kind):
    """`StepBundle.lower()` no longer raises: on the one-rank mesh it
    returns the record `launch.dryrun` reads."""
    cfg = get_smoke_config("smollm-360m")
    low = steps.make_step(kind, cfg, ShapeCell("s", *CELL, kind),
                          lmesh.make_host_mesh("cpu")).lower()
    assert isinstance(low, cost.Lowered) and low.total.flops > 0 and low.total.nbytes > 0
    assert low.total.coll_counts == {} and set(low.memory) == MEMORY_KEYS
    assert low.memory["argument_bytes"] > 0 and low.memory["temp_bytes"] >= 0


def test_private_apis_the_dry_run_leans_on():
    """The fake process group, group resolution, the boxed ProcessGroup of
    c10d ops, FlopCounterMode's formulas, the dispatch mode base and the
    context that leaves it (`sharding.init_states`'s shapes-only tree), the
    fake tensor class the counter leaves out, local_map and
    DTensor.from_local's global shape: each in the form the dry run calls
    it."""
    from torch._subclasses.fake_tensor import FakeTensor  # noqa: F401
    from torch.distributed.distributed_c10d import _resolve_process_group  # noqa: F401
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map  # noqa: F401
    from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401
    from torch.utils._python_dispatch import TorchDispatchMode  # noqa: F401
    from torch.utils._python_dispatch import _disable_current_modes  # noqa: F401
    from torch.utils.flop_counter import flop_registry

    import inspect

    assert torch.ops.aten.mm in flop_registry and torch.ops.aten.bmm in flop_registry
    assert hasattr(torch.distributed.ProcessGroup, "unbox")
    assert {"shape", "stride"} <= set(inspect.signature(DTensor.from_local).parameters)
    assert torch.Tag.reduction in torch.ops.aten.sum.dim_IntList.tags
    assert torch.ops.aten.view.default.is_view
    assert "repro_torch.launch.dryrun" in sys.modules or __import__("repro_torch.launch.dryrun")
