"""Peak-intermediate estimation for the statistics passes (the port's
counterpart of `repro.launch.memory`).

The question the streaming statistics have to answer — "does any
intermediate scale with N?" — is answered by
`repro_torch.analysis.trace_check`, which records every intermediate of an
eager call and classifies its scaling class from two problem sizes. This
module keeps the reference's byte-level entry points as thin wrappers, for
callers that want a number, not a class.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

from repro_torch.analysis.trace_check import trace_intermediates

__all__ = ["intermediate_report", "peak_intermediate_bytes"]


def intermediate_report(fn: Callable, *args, top: int = 8, backward: bool = False,
                        **kwargs) -> List[Tuple[Tuple[int, ...], str, int]]:
    """The `top` largest intermediates of `fn(*args)` (with its backward
    when asked) as [(shape, dtype, bytes)], largest first. Runs the call."""
    best = {}
    for shape, dtype, nbytes, _, _ in trace_intermediates(fn, *args, backward=backward,
                                                          **kwargs):
        best[(shape, dtype)] = nbytes
    rows = sorted(((s, d, b) for (s, d), b in best.items()), key=lambda r: -r[2])
    return rows[:top]


def peak_intermediate_bytes(fn: Callable, *args, backward: bool = False,
                            **kwargs) -> int:
    """Size in bytes of the largest single intermediate `fn(*args)` makes."""
    rows = intermediate_report(fn, *args, top=1, backward=backward, **kwargs)
    return rows[0][2] if rows else 0
