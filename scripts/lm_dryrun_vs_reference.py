"""One rank's counts of the LM smoke steps, the port's dry run beside the
reference's compiled HLO, on a (data 2, model 2) mesh (CPU only).

    PYTHONPATH=src python scripts/lm_dryrun_vs_reference.py [--archs a,b] [--seq 32 --batch 4]

The port's side (`StepBundle.lower()` on rank 0 of a fake four-rank
process group, layer loops multiplied) and the reference's (its steps
lowered and compiled on four host devices, `repro.launch.hlo_cost` over
the compiled HLO, `memory_analysis()`) each run in a child process of
their own, at once; this script imports neither package. Prints one
Markdown row a (arch, step): flops a chip, bytes a chip, argument and
output bytes, and the collectives' ring traffic of each side. The two
count different programs: eager PyTorch moves every op's operands and
result, XLA only across its fusions, and the reference's HLO is the
partitioner's, not DTensor's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("arctic-480b", "moonshot-v1-16b-a3b", "whisper-small", "gemma3-4b", "smollm-360m",
         "minicpm-2b", "internlm2-20b", "recurrentgemma-2b", "rwkv6-7b", "internvl2-2b")
KINDS = ("train", "prefill", "decode")

_PORT = r"""
import json, sys
from repro_torch.configs.base import ShapeCell, get_smoke_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as lmesh

archs, kinds, S, B = json.loads(sys.argv[1])
dryrun.open_fake_group(4)
mesh = lmesh.make_mesh((2, 2), ("data", "model"), "cuda")
out = {}
for arch in archs:
    for kind in kinds:
        low = steps.make_step(kind, get_smoke_config(arch), ShapeCell("s", S, B, kind),
                              mesh).lower()
        out[arch + "/" + kind] = [low.total.flops, low.total.nbytes,
                                  low.memory["argument_bytes"], low.memory["output_bytes"],
                                  low.total.traffic_bytes]
print(json.dumps(out))
"""

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro import compat
from repro.configs.base import ShapeCell, get_smoke_config
from repro.launch import hlo_cost
from repro.launch.steps import make_step

archs, kinds, S, B = json.loads(sys.argv[1])
mesh = compat.make_mesh((2, 2), ("data", "model"))
out = {}
for arch in archs:
    for kind in kinds:
        with mesh:
            compiled = make_step(kind, get_smoke_config(arch), ShapeCell("s", S, B, kind),
                                 mesh).lower().compile()
        cost = hlo_cost.analyze(compiled.as_text())
        ma = compiled.memory_analysis()
        out[arch + "/" + kind] = [cost.flops, cost.bytes, ma.argument_size_in_bytes,
                                  ma.output_size_in_bytes, cost.coll_traffic]
print(json.dumps(out))
"""


def _run(code: str, src: Path, arg: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(src), "JAX_PLATFORMS": "cpu"}
    return subprocess.Popen([sys.executable, "-c", code, arg], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    arg = json.dumps([args.archs.split(","), list(KINDS), args.seq, args.batch])
    procs = {"port": _run(_PORT, ROOT / "src", arg),
             "reference": _run(_REFERENCE, ROOT / "src", arg)}
    res = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=1800)
        if proc.returncode:
            print(f"{name} exited {proc.returncode}: {err[-3000:]}", file=sys.stderr)
            return 1
        res[name] = json.loads(out.strip().splitlines()[-1])
    print(f"smoke configs, {args.batch} x {args.seq}, rank 0 of (data 2, model 2); port / "
          f"reference")
    print("| arch | step | flops a chip | bytes a chip | argument bytes | output bytes | "
          "ring traffic (bytes) |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for key, p in res["port"].items():
        r = res["reference"][key]
        arch, kind = key.split("/")
        cells = " | ".join(f"{a:.4g} / {b:.4g}" for a, b in zip(p, r))
        print(f"| {arch} | {kind} | {cells} |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
