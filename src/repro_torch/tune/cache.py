"""Persistent winner store of the `repro_torch.tune` autotuner
(counterpart of `repro.tune.cache`).

One small JSON document holds every tuned decision this machine has made:

    {"schema_version": 1,
     "entries": {"blocks|kfu_pallas|float32|M=100|Q=1|cuda|NVIDIA H100 80GB HBM3":
                     {"winner": 2, ...}, ...}}

Location: ``$REPRO_TORCH_TUNE_CACHE`` when set, else
``~/.cache/repro_torch/tune.json`` — the port's own file and variable, so
the two packages never read or clobber each other's winners. Writes are
atomic (temp file + ``os.replace``), so a concurrent reader sees either the
previous or the new complete document, never a torn one. Reads are tolerant
by design: a missing, truncated, corrupt or schema-mismatched file loads as
an empty store — a stale cache can cost a re-tune, but it must never take
the library down.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

__all__ = ["SCHEMA_VERSION", "CACHE_ENV", "cache_path", "load_entries",
           "lookup", "store"]

SCHEMA_VERSION = 1
CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"

# guards read-merge-write cycles within this process; cross-process safety
# comes from the atomic replace (last writer wins per whole document)
_LOCK = threading.RLock()


def cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return os.path.expanduser(env)
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tune.json")


def load_entries(path: Optional[str] = None) -> Dict[str, Any]:
    """The entries mapping of the store at `path` (default `cache_path()`);
    {} for missing, unreadable, corrupt or schema-mismatched files."""
    path = cache_path() if path is None else path
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("schema_version") != SCHEMA_VERSION:
        return {}
    entries = doc.get("entries")
    return dict(entries) if isinstance(entries, dict) else {}


def lookup(key: str, path: Optional[str] = None) -> Any:
    """The stored value for `key`, or None."""
    return load_entries(path).get(key)


def store(key: str, value: Any, path: Optional[str] = None) -> None:
    """Merge one winner into the store atomically."""
    path = cache_path() if path is None else path
    with _LOCK:
        entries = load_entries(path)
        entries[key] = value
        doc = {"schema_version": SCHEMA_VERSION, "entries": entries}
        directory = os.path.dirname(path) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".tune-",
                                   suffix=".json")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(doc, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
