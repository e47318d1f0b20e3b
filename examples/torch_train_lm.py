"""End-to-end run of the PyTorch/CUDA port: train a ~100M-parameter LM
for a few hundred steps with the port's training stack — the train step,
the fault-tolerant loop, checkpointing, the WSD schedule and the
synthetic data pipeline.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6 --batch 2 --seq 32 --layers 2

The model is a 12-layer / d=768 smollm-family config (~110M parameters).
It runs on the host mesh: this process alone, or every rank of a process
group the caller started (parameters, Adam's state and batches placed by
the rules table); `--mesh pod` needs a process group of 256 ranks and
raises without one. Like the JAX example, it reports the final loss beside
the random-chance level ln V, and asserts that it is finite.
"""
import argparse
import dataclasses
import math
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import device as _device
from repro_torch.configs import ModelConfig, ShapeCell
from repro_torch.data import TokenStream
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model_zoo import build
from repro_torch.optim import AdamConfig, adam_init, wsd_schedule
from repro_torch.optim.adam import flatten
from repro_torch.parallel import sharding as shd
from repro_torch.runtime import LoopConfig, TrainLoop

CFG_100M = ModelConfig(
    name="lm-100m", family="dense",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
    d_ff=2048, vocab_size=32000, tie_embeddings=True,
    param_dtype="float32", compute_dtype="float32", remat=False, logits_chunk=128,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--layers", type=int, default=CFG_100M.num_layers,
                    help="depth (the widths stay the 100M config's)")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, resumed from if it holds one "
                         "(default: a fresh one under the temp dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(CFG_100M, num_layers=args.layers)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_train_lm")
    shape = ShapeCell("e2e", args.seq, args.batch, "train")
    mesh = (make_host_mesh(args.device) if args.mesh == "host"
            else make_production_mesh(multi_pod=args.mesh == "multipod", device=args.device))

    adam = AdamConfig(lr=wsd_schedule(3e-4, warmup_steps=min(20, args.steps // 3),
                                      stable_steps=args.steps // 2,
                                      decay_steps=max(1, args.steps // 3)),
                      weight_decay=0.1, clip_norm=1.0)
    dev = _device.resolve(args.device)
    bundle = make_train_step(cfg, shape, mesh, adam=adam, batch=args.batch)
    params = shd.place(build(cfg).init(0, device=dev), bundle.in_shardings[0])
    n = sum(t.numel() for t in flatten(params)[1])
    print(f"model: {n / 1e6:.1f}M params; mesh {shd.axis_sizes(mesh)} on {dev}")
    opt = shd.place(adam_init(params, adam), bundle.in_shardings[1])

    loop = TrainLoop(bundle.jitted(), params, opt,
                     TokenStream(cfg, shape, batch=args.batch, device=dev,
                                 shardings=bundle.in_shardings[2]),
                     LoopConfig(ckpt_dir=ckpt_dir, ckpt_every=100,
                                log_every=max(1, min(20, args.steps // 3))),
                     shardings=bundle.in_shardings[:2])
    final = loop.run(args.steps)
    print(f"done: final loss {final['loss']:.4f} (random-chance ~ "
          f"{math.log(cfg.vocab_size):.2f})")
    assert math.isfinite(final["loss"]), final
    return final


if __name__ == "__main__":
    main()
