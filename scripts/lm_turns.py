#!/usr/bin/env python3
"""The LM's host-bound times on one CUDA card, for one checkout's package, to
compare two trees on one machine in turns:

    git archive <rev> src | tar -x -C build/parent
    for t in build/parent/src src src build/parent/src; do python3 scripts/lm_turns.py $t; done

smollm-360m served at 4 x 512 + 64 and trained at 8 x 2,048 (median of 3
steps after the first), rwkv6-7b and recurrentgemma-2b served at 2 x 512 +
32, all at full width and depth in bf16, each served twice (the second
timed): prefill ms and decode ms a token step. One JSON line."""
import json, statistics, sys, time, dataclasses
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.configs import ShapeCell, get_config
from repro_torch.data import TokenStream
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo
from repro_torch.optim import adam_init

dev = torch.device("cuda", 0)
out = {"tree": sys.argv[1]}

def served(arch, B, S, n, layers=None):
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = model_zoo.build(cfg).init(0, device=dev)
    gen = torch.Generator(device=dev); gen.manual_seed(0)
    batch = model_zoo.make_batch(gen, cfg, ShapeCell("t", S, B, "prefill"), batch=B)
    serve.generate(cfg, params, batch, n)
    r = serve.generate(cfg, params, batch, n)
    del params; torch.cuda.empty_cache()
    return round(r.prefill_s * 1e3, 2), round(r.decode_s / n * 1e3, 3)

out["smollm_serve"] = served("smollm-360m", 4, 512, 64)
cfg = get_config("smollm-360m")
shape = ShapeCell("t", 2048, 8, "train")
bundle = steps.make_train_step(cfg, shape, make_host_mesh(dev), batch=8)
params = model_zoo.build(cfg).init(0, device=dev)
opt = adam_init(params, steps.default_adam(cfg))
data = TokenStream(cfg, shape, batch=8, device=dev).batch(0)
ts = []
for _ in range(4):
    torch.cuda.synchronize(); t0 = time.perf_counter()
    params, opt, m = bundle.fn(params, opt, data)
    torch.cuda.synchronize(); ts.append(time.perf_counter() - t0)
out["smollm_train_ms"] = round(statistics.median(ts[1:]) * 1e3, 1)
del params, opt; torch.cuda.empty_cache()
out["rwkv6_serve"] = served("rwkv6-7b", 2, 512, 32)
out["recurrentgemma_serve"] = served("recurrentgemma-2b", 2, 512, 32)
print(json.dumps(out), flush=True)
