"""The paper's technique composed with an assigned LM architecture, in the
PyTorch/CUDA port: a sparse-GP readout head (deep-kernel style) on
smollm-360m features, giving calibrated uncertainty on a regression
target.

    PYTHONPATH=src python examples/torch_gp_head_uncertainty.py
    PYTHONPATH=src python examples/torch_gp_head_uncertainty.py --device cpu

Pipeline: (1) run the (smoke-sized) smollm backbone to pool per-sequence
features; (2) train the GP head on the collapsed bound — the same
sufficient-statistics machinery as the GP-LVM, features being
deterministic inputs; (3) show that the predictive variance separates
in-distribution from out-of-distribution inputs, the JAX example's
criterion. Tokens come from a torch generator, so the draw is not the JAX
example's.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import gp_head
from repro_torch.core.inference import fit_adam
from repro_torch.models import model_zoo, transformer


@torch.no_grad()
def pooled_features(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Mean-pooled final hidden state (the backbone as a feature extractor)."""
    x = transformer._input_embeddings(params, {"tokens": tokens}, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    h, _, _ = transformer._backbone(params, x, positions, cfg, mode="train", states=None,
                                    cur_pos=None)
    return h.mean(dim=1)  # (B, d)


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("smollm-360m")
    model = model_zoo.build(cfg)
    params = model.init(0, device=args.device)
    gen = torch.Generator(device=params["embed"]["table"].device).manual_seed(0)

    # synthetic task: target = smooth function of token statistics
    B, S = 256, 32
    tokens = torch.randint(0, cfg.vocab_size // 2, (B, S), generator=gen,
                           dtype=torch.int32, device=gen.device)
    target = torch.sin(tokens.float().mean(dim=1) / 50.0)

    feats = pooled_features(params, tokens, cfg)
    print(f"features: {tuple(feats.shape)} from {cfg.name}")

    head = gp_head.init_head(0, feats.shape[1], M=32, device=args.device)
    l0 = float(gp_head.head_loss(head, feats, target))
    head, hist = fit_adam(gp_head.head_loss, head, (feats, target), steps=args.steps, lr=2e-2)
    print(f"head loss {l0:.3f} -> {hist[-1]:.3f}")

    # calibration: in-distribution vs OOD tokens (a disjoint vocabulary range)
    tokens_ood = torch.randint(cfg.vocab_size // 2, cfg.vocab_size, (32, S), generator=gen,
                               dtype=torch.int32, device=gen.device)
    feats_ood = pooled_features(params, tokens_ood, cfg)
    pred_in = gp_head.head_predict(head, feats, target, feats[:32])
    pred_ood = gp_head.head_predict(head, feats, target, feats_ood)
    v_in, v_ood = float(pred_in.var.mean()), float(pred_ood.var.mean())
    print(f"mean predictive variance: in-dist {v_in:.4f} vs OOD {v_ood:.4f}")
    assert v_ood > v_in, "OOD inputs should be more uncertain"
    print("GP head is calibrated: higher uncertainty off-manifold")
    return v_in, v_ood


if __name__ == "__main__":
    main()
