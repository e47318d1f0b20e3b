#!/usr/bin/env python3
"""Which collectives a gloo group carries for CUDA tensors in this torch,
plainly and through DTensor: each op in a fresh world of two spawned ranks
sharing cuda:0, with a timeout, so a crash or a hang shows as such.

    python3 scripts/gloo_cuda_probe.py          # one CUDA card

Prints one RESULT line a rank and op (ok / FAIL and the error) and the
ranks' exit codes (-11: a segmentation fault). `parallel/collectives.py`
routes the ones that fail through the host.
"""
import faulthandler
import multiprocessing
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_reduce_max", "all_reduce_bf16", "broadcast", "all_gather",
       "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single",
       "funcol_all_gather", "funcol_reduce_scatter", "funcol_all_to_all", "funcol_all_reduce",
       "dtensor_shard_to_replicate", "dtensor_shard_to_shard", "dtensor_partial_to_shard",
       "dtensor_partial_to_replicate")
TIMEOUT_S = 40


def _op(op: str, rank: int, world: int, dev) -> None:
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))
    group = mesh.get_group(1)
    full = torch.arange(16.0, device=dev).reshape(4, 4)
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "all_reduce_max":
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    elif op == "all_reduce_bf16":
        dist.all_reduce(x.bfloat16())
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
    elif op == "all_gather_into_tensor":
        out = torch.empty(world * 8, device=dev)
        dist.all_gather_into_tensor(out, x)
        assert torch.equal(out.cpu(), torch.cat([torch.arange(8.0) + r for r in range(world)]))
    elif op == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(8 // world, device=dev), x)
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
    elif op.startswith("funcol_"):
        fn = {"funcol_all_gather": lambda: funcol.all_gather_tensor(x, 0, group),
              "funcol_reduce_scatter": lambda: funcol.reduce_scatter_tensor(x, "sum", 0, group),
              "funcol_all_to_all": lambda: funcol.all_to_all_single(x, None, None, group),
              "funcol_all_reduce": lambda: funcol.all_reduce(x, "sum", group)}[op]
        y = fn()
        y = y.wait() if hasattr(y, "wait") else y
        y.cpu()
    else:
        shard = distribute_tensor(full, mesh, [Replicate(), Shard(0)], src_data_rank=None)
        part = DTensor.from_local(full.clone(), mesh, [Replicate(), Partial()], run_check=False)
        if op == "dtensor_shard_to_replicate":
            assert torch.equal(shard.full_tensor(), full)
        elif op == "dtensor_shard_to_shard":
            assert torch.equal(shard.redistribute(mesh, [Replicate(), Shard(1)]).full_tensor(),
                               full)
        elif op == "dtensor_partial_to_shard":
            got = part.redistribute(mesh, [Replicate(), Shard(0)]).to_local()
            assert torch.equal(got, (full * world).chunk(world)[rank])
        else:
            got = part.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            assert torch.equal(got, full * world)


def _rank(op: str, rank: int, world: int, store: str) -> None:
    faulthandler.enable()
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        _op(op, rank, world, dev)
        torch.cuda.synchronize()
        print(f"RESULT {op} rank {rank} ok", flush=True)
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        print(f"RESULT {op} rank {rank} FAIL {type(e).__name__}: {str(e)[:300]}", flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: needs a CUDA device", file=sys.stderr)
        return 2
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        for op in OPS:
            store = str(Path(tmp) / f"store_{op}")
            procs = [ctx.Process(target=_rank, args=(op, r, 2, store)) for r in range(2)]
            for p in procs:
                p.start()
            deadline = time.monotonic() + TIMEOUT_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join(5)
            print(f"EXIT {op} {[p.exitcode for p in procs]}" + (" (hung)" if hung else ""),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
