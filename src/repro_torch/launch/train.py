"""Training launcher (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --preset smoke \\
        --steps 20 --batch 8 --seq 128 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --preset full

`--preset full` uses the architecture's config unchanged, `--preset smoke`
the reduced same-family config. `--mesh host` runs on every rank of the
current process group as (data = 1, model = world), or on this process
alone when there is none; `pod` / `multipod` need a process group of 256
/ 512 ranks. Every rank draws the same parameters from the seed and keeps
its own slices; Adam's state and each batch are placed by the step's
shardings. CUDA unless `--device cpu` (a host without a CUDA device
raises). The loop checkpoints and resumes through `runtime.train_loop`,
onto whatever mesh it runs on. Every family runs: the audio family's
batches carry encoder frames and the vlm family's a prefix of patch
embeddings (`data.TokenStream`).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig, ShapeCell, get_config, get_smoke_config
from repro_torch.data.synthetic import TokenStream
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import StepBundle, default_adam, make_train_step
from repro_torch.models.model_zoo import build
from repro_torch.optim import adam_init
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.train_loop import LoopConfig, TrainLoop


@dataclasses.dataclass
class TrainSetup:
    cfg: ModelConfig
    shape: ShapeCell
    bundle: StepBundle
    params: Any
    opt: Any
    data: TokenStream
    loop_cfg: LoopConfig


def make_mesh(kind: str, device):
    if kind == "host":
        return make_host_mesh(device)
    return make_production_mesh(multi_pod=kind == "multipod", device=device)


def setup(arch: str, preset: str = "smoke", *, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, ckpt_dir: str | None = None, ckpt_every: int = 50,
          mesh: str = "host", device="cuda", seed: int = 0,
          log_every: int = 1) -> TrainSetup:
    """Everything `main` builds before the loop runs: the config, the train
    step at `lr` on the mesh, parameters from `seed` and Adam's state
    placed by the step's in_shardings, the token stream (each batch placed
    likewise) and the loop's config. `ckpt_dir` defaults to `repro_train`
    under `tempfile.gettempdir()`, so it follows the caller's TMPDIR."""
    cfg = get_smoke_config(arch) if preset == "smoke" else get_config(arch)
    shape = ShapeCell("cli", seq, batch, "train")
    dev = _device.resolve(device)
    the_mesh = make_mesh(mesh, dev)
    adam = dataclasses.replace(default_adam(cfg), lr=lr)
    bundle = make_train_step(cfg, shape, the_mesh, adam=adam, batch=batch)
    params = shd.place(build(cfg).init(seed, device=dev), bundle.in_shardings[0])
    opt = shd.place(adam_init(params, adam), bundle.in_shardings[1])
    data = TokenStream(cfg, shape, batch=batch, device=dev, shardings=bundle.in_shardings[2])
    if ckpt_dir is None:
        ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_train")
    loop_cfg = LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, log_every=log_every)
    return TrainSetup(cfg, shape, bundle, params, opt, data, loop_cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--preset", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_train under the temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    s = setup(args.arch, args.preset, batch=args.batch, seq=args.seq, lr=args.lr,
              ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, mesh=args.mesh,
              device=args.device)
    loop = TrainLoop(s.bundle.jitted(), s.params, s.opt, s.data, s.loop_cfg,
                     shardings=s.bundle.in_shardings[:2])
    final = loop.run(args.steps)
    print("final metrics:", final)
    return final


if __name__ == "__main__":
    main()
