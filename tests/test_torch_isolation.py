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
print(len(names), leaked)
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT)])}
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) >= 31  # every module of the port, checkpoint/ and tune/ too
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
