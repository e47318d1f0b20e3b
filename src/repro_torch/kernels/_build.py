"""Build and bind the port's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` into a shared library with
a plain C interface and loaded with `ctypes` (no PyTorch headers, so a
build takes seconds rather than minutes). The build runs at first use, into
`build/` at the root of the checkout, and is cached by the content hash of
the source and the shared headers (`csrc/*.cuh`): a library whose name
carries the current hash is reused, anything else is rebuilt. Nothing here
runs when the module is imported.

A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

from repro_torch.analysis import lockdep

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# one entry per kernel library: name -> its single .cu source
SOURCES: Dict[str, Path] = {
    name: CSRC / f"{name}.cu"
    for name in ("suffstats_fwd", "suffstats_bwd", "psi2_fwd", "psi2_bwd",
                 "psi1_fwd", "psi1_bwd", "kfu_fwd")
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = lockdep.named_lock("repro_torch.kernels._build._lock")
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's output incl. the -Xptxas -v register report)
# of the builds this process ran
BUILD_LOG: Dict[str, Tuple[float, str]] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(name: str) -> Path:
    """The library's path, keyed by its source and every shared header."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp), _target(name), time.perf_counter()


def _finish(name: str, proc: subprocess.Popen, tmp: Path, target: Path,
            t0: float) -> None:
    out, _ = proc.communicate()
    BUILD_LOG[name] = (time.perf_counter() - t0, out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {SOURCES[name].name} "
                           f"(exit {proc.returncode}):\n{out}")
    report = target.with_suffix(".ptxas.txt")
    report.write_text(out)  # the -Xptxas -v report, for a later process
    os.replace(tmp, target)  # atomic: a concurrent build sees old or new


def ptxas_report(name: str) -> str | None:
    """nvcc's output for the current library `name` (its -Xptxas -v
    register report): this process's build, else the report the build that
    made the library left beside it; None where neither exists."""
    if name in BUILD_LOG:
        return BUILD_LOG[name][1]
    report = _target(name).with_suffix(".ptxas.txt")
    return report.read_text() if report.exists() else None


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Build every named library whose current source has no library yet,
    one nvcc process per source, all started together. Returns name ->
    library path."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names if not _target(n).exists()}
        errors = []
        for n, job in started.items():
            try:
                _finish(n, *job)
            except RuntimeError as e:
                errors.append(e)
        if errors:
            raise errors[0]
    return {n: _target(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build([name])[name]
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
    return lib
