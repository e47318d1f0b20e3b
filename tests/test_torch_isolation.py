"""The port stands alone: importing every `repro_torch` module and
`chip_smoke` pulls in neither `jax` nor anything of `repro`, and an entry
point called without ``device=`` on a host with no CUDA device raises
instead of quietly running on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked, ",".join(names))
"""

# the analysis passes and launch tools; among them the stdlib-only lock
# model and verifier the port's lock-holding modules import
NEW_MODULES = {
    "repro_torch.analysis", "repro_torch.analysis.__main__",
    "repro_torch.analysis.concurrency", "repro_torch.analysis.kernel_audit",
    "repro_torch.analysis.lint", "repro_torch.analysis.lockdep",
    "repro_torch.analysis.trace_check", "repro_torch.launch",
    "repro_torch.launch.cost", "repro_torch.launch.gp_dryrun",
    "repro_torch.launch.memory", "repro_torch.launch.roofline",
    # the dense LM side
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.smollm_360m",
    "repro_torch.configs.gemma3_4b", "repro_torch.configs.minicpm_2b",
    "repro_torch.configs.internlm2_20b", "repro_torch.configs.arctic_480b",
    "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.whisper_small",
    "repro_torch.configs.recurrentgemma_2b", "repro_torch.configs.rwkv6_7b",
    "repro_torch.configs.internvl2_2b", "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.attention", "repro_torch.models.transformer",
    "repro_torch.models.model_zoo", "repro_torch.optim.schedule", "repro_torch.launch.mesh",
    "repro_torch.launch.steps", "repro_torch.launch.train", "repro_torch.launch.serve",
    "repro_torch.runtime", "repro_torch.runtime.train_loop", "repro_torch.core.gp_head",
    "repro_torch.core.gp_kernels",
    # the remaining single-device families and optim/compression
    "repro_torch.models.rglru", "repro_torch.models.rwkv6", "repro_torch.models.moe",
    "repro_torch.models.encdec", "repro_torch.models.frontends",
    "repro_torch.optim.compression",
    # parallel/ and runtime/elastic
    "repro_torch.parallel", "repro_torch.parallel.sharding",
    "repro_torch.parallel.collectives", "repro_torch.runtime.elastic",
}


def test_port_imports_no_jax_and_nothing_of_repro():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked, names = out.stdout.strip().split(" ", 2)
    assert int(count) >= 75  # every module of the port: analysis/, launch/, the LM side
    assert NEW_MODULES <= set(names.split(","))
    assert leaked == "[]", leaked


def test_entry_points_default_to_cuda_and_refuse_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default is legitimate")
    from repro_torch import convert
    from repro_torch.data import gplvm_synthetic
    from repro_torch.gp import (BayesianGPLVM, SparseGPRegression,
                                TemporalGPRegression, available, get,
                                regression)
    from repro_torch.serve import GPServer

    params = {"kern": {"log_variance": 0.0, "log_lengthscale": np.zeros(1)},
              "Z": np.zeros((3, 1)), "log_beta": 0.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPServer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_numpy(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get("rbf")(1).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SparseGPRegression()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BayesianGPLVM(backend="fused")
    for name in available():
        kern = get(name)(get("rbf")(1), get("linear")(1)) \
            if name in ("sum", "product") else get(name)(1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            kern.init()
        assert all(t.device.type == "cpu"
                   for t in _leaves(kern.init(device="cpu")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TemporalGPRegression()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        regression(get("matern32")(1), backend="temporal")
    fields = {"kern": {"log_variance": 0.0, "log_lengthscale": np.zeros(1)},
              "log_beta": 0.0, "t_last": 1.0, "m": np.zeros((2, 1)),
              "P": np.eye(2), "n": 3.0}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.temporal_state_from_numpy(fields)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gplvm_synthetic(0, 8)
    from repro_torch.launch import gp_dryrun
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp_dryrun.main(["--n", "64", "--m", "4", "--out", "unused.json"])
    # the LM side: models, states, data, the head and both launchers
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.core import gp_head
    from repro_torch.data import TokenStream
    from repro_torch.launch import serve, train
    from repro_torch.models import model_zoo
    lm = model_zoo.build(get_smoke_config("smollm-360m"))
    for call in (lm.init, lambda: lm.init_decode_state(1, 8),
                 lambda: TokenStream(lm.cfg, ShapeCell("t", 8, 1, "train")),
                 lambda: gp_head.init_head(0, 4, M=3),
                 lambda: train.main(["--arch", "smollm-360m", "--steps", "1"]),
                 lambda: serve.main(["--arch", "smollm-360m"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert lm.init(device="meta")["embed"]["table"].device.type == "meta"
    # the same calls run where the caller asks for the CPU
    GPServer(device="cpu").close()
    assert convert.params_from_numpy(params, device="cpu")["Z"].device.type == "cpu"
    assert BayesianGPLVM(device="cpu").device.type == "cpu"
    assert TemporalGPRegression(device="cpu").device.type == "cpu"
    assert regression(get("matern32")(1), backend="temporal",
                      device="cpu").device.type == "cpu"
    assert convert.temporal_state_from_numpy(fields, device="cpu").P.device.type == "cpu"


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
