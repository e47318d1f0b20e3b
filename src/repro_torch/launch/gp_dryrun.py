"""The paper's own workload at production scale, run for real: one
data-parallel Bayesian GP-LVM Adam step (the port's counterpart of
`repro.launch.gp_dryrun`, which could only compile it for a TPU pod).

    python -m repro_torch.launch.gp_dryrun --n 16777216 --m 128 --q 1 --d 3 \\
        --backend fused [--world W] [--device cuda] [--dtype float32] \\
        [--out PATH]

The step is the reference's: `core.distributed.gplvm_loss_dist` through
`--backend` ("fused": B1 forward, B2 reverse on the card), its gradient,
and the reference's Adam (lr 1e-2, no clipping, no weight decay) over the
reference's parameters (kern {log_variance, log_lengthscale (Q,)}, Z (M, Q),
log_beta, q_mu and q_logS (N, Q)), each rank holding its shard of Y (N, D)
and q(X). The data come from a seed on the device. The inducing points
lie one unit apart over [-(M-1)/2, (M-1)/2] in each latent dimension
(each dimension's grid rolled by its index, so no two coincide) and the
lengthscale starts at 1, so Kuu's condition number stays near 64 at every
M; the latents are uniform over [-M/2, M/2] and q_mu starts at them,
q_logS at log 0.1; the outputs are a random-feature draw of an RBF GP of
lengthscale about 1 plus noise. The latents lie far out in the prior's
tails, so the KL term carries most of the loss (about M^2 / 24 a point);
the data term alone moves Z's, the kernel's and log_beta's gradients.
Packed into [-2, 2] with the lengthscale at 1, as a first version of this
draw had them, 128 inducing points make Kuu singular to float64's
precision and the float32 loss rounding noise; with the lengthscale
shrunk to their spacing instead, Adam's first step (every coordinate
moved by the learning rate) moves q_mu and Z by a third of a lengthscale
and the loss rises. `tests/test_torch_launch.py` holds the float32 steps
to float64's and their losses to a fall at every step.

It prints and writes the reference's record, with the measured step in
place of `compile_s`: the backend, the number of ranks (`n_chips`), the
median step time after the first (host clock to a synchronize), the peak
device memory (`torch.cuda.max_memory_allocated`) beside the state's bytes
(parameters, Y, gradients, Adam's moments), the flops, exps and HBM bytes
a rank's step must do and the collective bytes it sends (`launch.cost`),
the roofline terms with the dominant one, the step's share of its lower
bound, each kernel's launches over the steps (its wrapper's counter; the
plain versions on the CPU launch none) and the first step's statistics
passes. On the card the record also carries
`nvidia-smi --query-gpu=name,power.limit`.

W = 1 runs in this process (a process group of one); W > 1 spawns W ranks
on `tcp://localhost:<free port>`, rank r on cuda:r where the host has W
cards (NCCL), else all on cuda:0 (gloo, which NCCL refuses). The
reference's `--mesh pod|multipod` are 256- and 512-chip TPU meshes with no
counterpart on one host of cards; the port's `launch/mesh.py` comes with
the LM slice. The record is written under `experiments/dryrun_torch/`
(never the reference's `experiments/dryrun/`) unless `--out` names a file.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import math
import socket
import statistics
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.core import distributed, inference
from repro_torch.kernels import kfu as kf
from repro_torch.kernels import ops
from repro_torch.kernels import psi1 as p1
from repro_torch.kernels import psi2 as p2
from repro_torch.kernels import suffstats as ss
from repro_torch.launch import cost
from repro_torch.optim import AdamConfig, adam_init, adam_update
from repro_torch.optim.adam import flatten

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# the reference's Adam settings (src/repro/launch/gp_dryrun.py)
ADAM = AdamConfig(lr=1e-2, clip_norm=None, weight_decay=0.0)
DTYPES = {"float32": torch.float32, "float64": torch.float64}
BACKENDS = ("jnp", "fused")
STEPS = 5  # Adam steps; the step time is the median after the first
SEED = 0
# rows a slice of the data draw makes at once on the device
_DRAW_ROWS = 1 << 20
_FEATURES = 64
_TIMEOUT = datetime.timedelta(seconds=600)


def make_problem(N: int, M: int, Q: int, D: int, *, dtype: torch.dtype,
                 device, seed: int = 0):
    """(params, Y) of the dry run on `device` (module docstring), drawn
    from `seed` by a generator on that device."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    kw = dict(generator=g, device=dev, dtype=dtype)
    X = M * torch.rand(N, Q, **kw) - M / 2
    omega = torch.randn(Q, _FEATURES, **kw)
    phase = 2 * math.pi * torch.rand(_FEATURES, **kw)
    W = torch.randn(_FEATURES, D, **kw) * math.sqrt(2.0 / _FEATURES)
    Y = torch.empty(N, D, device=dev, dtype=dtype)
    for lo in range(0, N, _DRAW_ROWS):
        hi = min(lo + _DRAW_ROWS, N)
        Y[lo:hi] = torch.cos(X[lo:hi] @ omega + phase) @ W
        Y[lo:hi] += 0.05 * torch.randn(hi - lo, D, **kw)
    grid = torch.linspace(-(M - 1) / 2, (M - 1) / 2, M, device=dev, dtype=dtype)
    Z = torch.stack([grid.roll(q * M // Q) for q in range(Q)], dim=1)
    params = {
        "kern": {"log_variance": torch.zeros((), device=dev, dtype=dtype),
                 "log_lengthscale": torch.zeros(Q, device=dev, dtype=dtype)},
        "Z": Z,
        "log_beta": torch.full((), math.log(100.0), device=dev, dtype=dtype),
        "q_mu": X,
        "q_logS": torch.full((N, Q), math.log(0.1), device=dev, dtype=dtype),
    }
    return params, Y


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(rank: int, world: int, dev: torch.device,
                  init_method: Optional[str] = None):
    """The default process group for this rank (NCCL when each rank has a
    card of its own, else gloo), torn down on exit; an already initialized
    group is used as it is."""
    if dist.is_initialized():
        yield
        return
    own_card = dev.type == "cuda" and torch.cuda.device_count() >= world
    dist.init_process_group("nccl" if own_card else "gloo",
                            init_method=init_method or f"tcp://localhost:{_free_port()}",
                            world_size=world, rank=rank, timeout=_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def loss_fn(mesh, backend: str):
    """The reference's distributed GP-LVM loss on `mesh`."""
    return distributed.gplvm_loss_dist(mesh, backend=backend)


def train_step(loss, params, opt, Y):
    """One Adam step: (params, opt, the loss before it)."""
    value, grads = inference.value_and_grad(loss, params, (Y,))
    params, opt, _ = adam_update(grads, opt, params, ADAM)
    return params, opt, value


def launch_counts() -> Dict[str, int]:
    """Each kernel library's launch counter (the wrappers' own)."""
    return {"suffstats_fwd": ss.LAUNCHES, "suffstats_bwd": ss.BWD_LAUNCHES,
            "psi2_fwd": p2.LAUNCHES, "psi2_bwd": ss.PSI2_BWD_LAUNCHES,
            "psi1_fwd": p1.LAUNCHES, "psi1_bwd": ss.PSI1_BWD_LAUNCHES,
            "kfu_fwd": kf.LAUNCHES}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _state_bytes(params, Y) -> int:
    """Parameters, Y, gradients and Adam's two moments."""
    p = sum(t.numel() * t.element_size() for t in flatten(params)[1])
    return 4 * p + Y.numel() * Y.element_size()


def card_line() -> Optional[str]:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_rank(rank: int, world: int, args, init_method: Optional[str] = None) -> Dict:
    """Build the problem, take STEPS Adam steps on this rank's shard
    and return the record (every rank computes it; rank 0's is kept)."""
    dev = _device.resolve(args.device)
    if dev.type == "cuda":
        if world > 1:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dtype = DTYPES[args.dtype]
    N, M, Q, D = args.n, args.m, args.q, args.d
    with process_group(rank, world, dev, init_method):
        mesh = distributed.make_gp_mesh(device_type=dev.type)
        params, Y = make_problem(N, M, Q, D, dtype=dtype, device=dev, seed=SEED)
        params = distributed.shard_gp_params(params, mesh)
        Y = distributed.shard(Y, mesh)
        state = _state_bytes(params, Y)
        loss = loss_fn(mesh, args.backend)
        opt = adam_init(params, ADAM)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        times, losses, passes = [], [], []
        before = launch_counts()
        for step in range(STEPS):
            _sync(dev)
            t0 = time.perf_counter()
            with ops.recording() as log:
                params, opt, value = train_step(loss, params, opt, Y)
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(value))
            if step == 0:
                passes = list(log)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        n_local = Y.shape[0]
    step_cost = cost.gplvm_step_cost(passes, N=n_local, M=M, Q=Q, D=D, dtype=dtype,
                                     world=world)
    terms = step_cost.terms()
    step_ms = statistics.median(times[1:])
    return {
        "arch": f"gplvm-N{N}-M{M}", "shape": "train_gp", "kind": "train",
        "global_batch": N, "status": "ok", "backend": args.backend,
        "n_chips": world, "device": str(dev), "dtype": args.dtype,
        "card": card_line() if dev.type == "cuda" else None,
        "step_ms": step_ms, "steps_ms": times, "losses": losses,
        "memory": {"peak_bytes": peak, "state_bytes": state},
        "launches": launched,
        "passes": [p._replace(dtype=str(p.dtype).removeprefix("torch."))._asdict()
                   for p in passes],
        "flops_per_chip": step_cost.flops, "exps_per_chip": step_cost.exps,
        "bytes_per_chip": step_cost.nbytes,
        "collectives": {"traffic_bytes_per_chip": step_cost.collective_bytes},
        "parts": step_cost.table(),
        "roofline": terms,
        "share_of_bound": terms["step_lower_bound_s"] * 1e3 / step_ms,
    }


def _rank_main(rank: int, world: int, args, init_method: str, out: str) -> None:
    rec = run_rank(rank, world, args, init_method)
    if rank == 0:
        Path(out).write_text(json.dumps(rec))


def run(args) -> Dict:
    """The record of `args` (one rank in this process, or W spawned)."""
    if args.world == 1:
        return run_rank(0, 1, args)
    import tempfile

    import torch.multiprocessing as mp

    _device.resolve(args.device)  # fail here, not in W children
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "record.json")
        mp.spawn(_rank_main, args=(args.world, args, f"tcp://localhost:{_free_port()}", out),
                 nprocs=args.world, join=True)
        return json.loads(Path(out).read_text())


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.gp_dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=16_777_216)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--q", type=int, default=1)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--backend", default="fused", choices=BACKENDS)
    ap.add_argument("--world", type=int, default=1, help="data-parallel ranks")
    ap.add_argument("--device", default=_device.DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--out", default=None, help="the record's file (default: "
                    "experiments/dryrun_torch/gplvm_<backend>_w<W>_<dtype>.json)")
    args = ap.parse_args(argv)
    if args.world < 1:
        ap.error("--world must be at least 1")
    return args


def main(argv=None) -> Dict:
    args = parse_args(argv)
    rec = run(args)
    out = Path(args.out) if args.out else (
        OUT_DIR / f"gplvm_{args.backend}_w{args.world}_{args.dtype}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=2))
    r = rec["roofline"]
    peak = rec["memory"]["peak_bytes"]
    print(json.dumps({k: rec[k] for k in ("backend", "n_chips", "step_ms",
                                          "flops_per_chip", "bytes_per_chip")}, indent=1))
    print(f"terms: compute {r['t_compute_s'] * 1e3:.3f} ms ({r['compute_term']}) | "
          f"memory {r['t_memory_s'] * 1e3:.3f} ms | collective "
          f"{r['t_collective_s'] * 1e3:.3f} ms | dominant {r['dominant']} | step "
          f"{rec['step_ms']:.3f} ms, {100 * rec['share_of_bound']:.1f} % of its bound | "
          f"peak {'not measured' if peak is None else f'{peak / 2**30:.3f} GiB'} "
          f"(state {rec['memory']['state_bytes'] / 2**30:.3f} GiB)"
          + (f" | {rec['card']}" if rec["card"] else ""))
    return rec


if __name__ == "__main__":
    main()
