"""The program's spans: named ranges on the profiler's timeline.

`span(name)` enters `torch.profiler.record_function(name)` only while a
profiler is running; otherwise it costs one check of the profiler's flag
(`record_function` itself costs microseconds even with no profiler on).
Its events lie on the profiler's clock beside the device's activity, so a
trace reader can put each launch, synchronization and idle gap down to the
span open at the time. The spans are named `repro_torch.<layer>`:

  * `forward`, `backward`: `core.inference.value_and_grad`'s loss and its
    reverse pass;
  * `stats`: `core.gplvm.local_stats`, the statistics forward;
  * `epilogue`: `core.gplvm.bound_from_stats` (the O(M^3) bound) and
    `serve.state.build_state` (the refold);
  * `adam`: `optim.adam.adam_update`.

`traced(name)` is the same span around a whole function, as a decorator.
"""
from __future__ import annotations

import contextlib
import functools

from torch.autograd import profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: the profiler's range `name` while a profiler is
    running, else nothing."""
    if profiler._is_profiler_enabled:
        return profiler.record_function(name)
    return _OFF


def traced(name: str):
    """A decorator: each call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
