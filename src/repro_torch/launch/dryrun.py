"""The LM dry run (counterpart of `repro.launch.dryrun`): trace every
(arch x shape x mesh) cell's step on one rank of a fake process group, with
no storage, and write a JSON record a cell under experiments/dryrun_torch/.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

The reference lowers and compiles each step with `ShapeDtypeStruct` inputs
on 512 host devices and reads XLA's memory and cost analyses. Here a fake
process group of 256 (pod) or 512 (multipod) ranks (`torch.testing.
_internal.distributed.fake_pg`, whose collectives do nothing) stands for
the cluster in this one process, `launch.mesh.make_production_mesh` lays
a CUDA device mesh over it (no device is touched, so no card is needed),
and `StepBundle.lower()` traces rank 0's step on meta-device shards of
its arguments (`launch.cost.lower`): its operations, bytes and collectives
counted with each layer loop traced once and multiplied, and its live
bytes tracked. The record has the reference's keys: memory (a rank's
argument, output, temporary and aliased bytes, and its peak), the flops
and bytes a chip, the counts with each loop body taken once (where the
reference keeps XLA's own `xla_*_scan_once`), the collectives, the H100
roofline terms (`launch.roofline.lm_roofline_terms`), the reference's
MODEL_FLOPS and the useful share of the counted flops. `compile_s` is
null: eager code has no compile step. A cell that raises is recorded with
its error and the sweep goes on; the exit status is 1 if any cell erred.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import ARCH_IDS, SHAPES, cell_applicable, get_config
from repro_torch.launch import roofline

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESH_RANKS = {"pod": 256, "multipod": 512}
PEAK_OPS = 6  # the ops a record names at the traced peak


def open_fake_group(world: int, rank: int = 0) -> None:
    """A fake process group of `world` ranks in this process, as rank
    `rank` (any group open before is closed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)


def record_of(bundle, lowered, cfg, shape) -> dict:
    """The reference's record keys of a lowered step (`StepBundle.lower()`)."""
    total, once = lowered.total, lowered.once
    terms = lowered.terms()
    params_a = bundle.abstract_args[0]
    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mf = roofline.model_flops(cfg, params_a, n_tokens)
    if shape.kind != "train":
        # 6ND counts forward and reverse; prefill and decode run forward only: 2ND
        mf["model_flops"] /= 3.0
    flops, mesh_size = total.flops, lowered.n_ranks
    return {
        "status": "ok",
        "n_chips": mesh_size,
        "lower_s": round(lowered.lower_s, 2),
        "compile_s": lowered.compile_s,
        "memory": dict(lowered.memory),
        "flops_per_chip": flops,
        "bytes_per_chip": total.nbytes,
        "xla_flops_scan_once": once.flops,
        "xla_bytes_scan_once": once.nbytes,
        "matmul_flops_per_chip": dict(total.matmul_flops),
        "other_flops_per_chip": dict(total.other_flops),
        "collectives": {
            "counts": dict(total.coll_counts),
            "raw_bytes_per_chip": dict(total.coll_raw),
            "traffic_bytes_per_chip": total.traffic_bytes,
            "traffic_by_link": dict(total.traffic),
        },
        "roofline": terms,
        "model_flops": mf,
        "useful_compute_fraction": mf["model_flops"] / (flops * mesh_size) if flops else 0.0,
        "n_params_total": roofline.count_params(params_a),
        # the live bytes at the traced peak by the op that made them, largest first
        "peak_by_op": dict(sorted(lowered.peak_by_op.items(), key=lambda kv: -kv[1])[:PEAK_OPS]),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: Path,
             force: bool = False) -> dict:
    """One cell: its record, from the cache unless `force`. The fake group
    of the cell's mesh must be open (`open_fake_group`)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import make_step

    mesh_name = "multipod" if multi_pod else "pod"
    out_path = out_dir / f"{arch}_{shape_name}_{mesh_name}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        print(f"[cached] {arch} x {shape_name} x {mesh_name}: {rec.get('status')}")
        return rec

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "seq_len": shape.seq_len, "global_batch": shape.global_batch,
    }
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        out_path.write_text(json.dumps(rec, indent=2))
        print(f"[skip]   {arch} x {shape_name}: {why}")
        return rec

    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device="cuda")
        bundle = make_step(shape.kind, cfg, shape, mesh)
        lowered = bundle.lower()
        rec.update(record_of(bundle, lowered, cfg, shape))
        terms = rec["roofline"]
        hbm_gb = rec["memory"]["peak_hbm_bytes_est"] / 2**30
        print(f"[ok]     {arch} x {shape_name} x {mesh_name}: lower {lowered.lower_s:.1f}s, "
              f"{hbm_gb:.2f} GiB/chip, dominant={terms['dominant']} "
              f"bound={terms['step_lower_bound_s'] * 1e3:.2f} ms "
              f"useful={rec['useful_compute_fraction']:.2f}", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL]   {arch} x {shape_name} x {mesh_name}: {type(e).__name__}: {e}",
              flush=True)
    out_path.write_text(json.dumps(rec, indent=2))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape cell or 'all'")
    ap.add_argument("--mesh", default="both", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--force", action="store_true", help="recompute cached cells")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    n_fail = 0
    for multi in meshes:  # one fake group a mesh: the production meshes use all its ranks
        open_fake_group(MESH_RANKS["multipod" if multi else "pod"])
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, multi, out_dir, force=args.force)
                n_fail += rec.get("status") == "error"
    import torch.distributed as dist

    dist.destroy_process_group()
    print(f"done in {time.time() - t0:.1f}s; {n_fail} failures")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
