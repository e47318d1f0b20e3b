"""The PyTorch examples' `main` at smoke size on the CPU (``--device cpu``,
the plain PyTorch versions), each asserting its own success criteria —
the JAX twins' criteria — as it does on the card. A few seconds each."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("backend", ("jnp", "fused", "pallas"))
def test_torch_quickstart(backend, capsys):
    rmse = _load("torch_quickstart").main(
        ["--device", "cpu", "--n", "400", "--steps", "30", "--max-rmse", "0.3",
         "--backend", backend])
    assert rmse < 0.3
    assert "quickstart OK" in capsys.readouterr().out


def test_torch_gplvm_synthetic(capsys):
    # the default N's draw; fewer inducing points and steps than the default
    corr = _load("torch_gplvm_synthetic").main(
        ["--device", "cpu", "--m", "16", "--steps", "30", "--min-corr", "0.9",
         "--backend", "fused"])
    assert corr > 0.9
    assert "paper reproduction OK" in capsys.readouterr().out


def test_torch_temporal_quickstart(capsys):
    errors = _load("torch_temporal_quickstart").main(
        ["--device", "cpu", "--n", "4000", "--steps", "30"])
    assert len(errors) == 20 and np.isfinite(errors).all()
    assert "temporal quickstart OK" in capsys.readouterr().out


def test_torch_serve_quickstart(capsys):
    before, after = _load("torch_serve_quickstart").main(
        ["--device", "cpu", "--n", "1000", "--steps", "60"])
    assert after < 0.5 * before and after < 0.2
    assert "serve quickstart OK" in capsys.readouterr().out


def test_torch_gp_head_uncertainty(capsys):
    v_in, v_ood = _load("torch_gp_head_uncertainty").main(["--device", "cpu", "--steps", "60"])
    assert v_ood > v_in
    assert "GP head is calibrated" in capsys.readouterr().out


def test_torch_train_lm(tmp_path, capsys):
    final = _load("torch_train_lm").main(
        ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "32", "--layers", "2",
         "--ckpt-dir", str(tmp_path / "ck")])
    assert np.isfinite(final["loss"])
    assert "done: final loss" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="needs 256 devices.*has 1 rank"):
        _load("torch_train_lm").main(["--device", "cpu", "--mesh", "pod"])


def test_examples_default_to_the_card():
    for name in ("torch_quickstart", "torch_gplvm_synthetic", "torch_temporal_quickstart",
                 "torch_serve_quickstart", "torch_gp_head_uncertainty", "torch_train_lm"):
        src = (EXAMPLES / f"{name}.py").read_text()
        assert 'ap.add_argument("--device", default="cuda")' in src, name
        assert "import jax" not in src and "from repro." not in src, name
