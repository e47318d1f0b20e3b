"""Reading a traced window: `torch.profiler` over CPU and CUDA, reduced to
what the per-layer readers need.

  * the window is the benchmark's own span `gpbench.window`;
  * busy time is the union of the device's activity intervals inside it;
  * an op's device time is the time of the device work whose launch (a
    runtime or driver call, matched by correlation id) the op or its
    children made, summed over the op's calls;
  * each kernel's device seconds by name (the collectives' kernels
    among them);
  * the breakdown: the device operations that took most time, and the
    longest idle gaps, each named by the innermost host op that was
    running when the device went idle.
"""
from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

WINDOW_SPAN = "gpbench.window"
SPAN_PREFIX = "gpbench."  # the benchmark's own record_function spans
TOP = 10


class Traced(NamedTuple):
    window_s: float
    busy_s: float
    op_device_s: Dict[str, float]  # op name -> device seconds inside the window
    op_calls: Dict[str, int]
    op_names: Dict[str, List[str]]  # the distinct event names that mention each op
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    kernel_s: Dict[str, float]  # device seconds by kernel name inside the window, all of them


@contextlib.contextmanager
def profiling():
    """The profiler over the block; yields a list that holds it afterwards."""
    from torch.profiler import ProfilerActivity, profile

    holder = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.append(prof)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_op(name: str, op: str) -> bool:
    """The profiler names a custom Function's forward after its class and
    its reverse node "autograd::engine::evaluate_function: <Node>", which
    wraps the node's own event: count the wrapper only."""
    return name == op or name == f"autograd::engine::evaluate_function: {op}"


def summarize(prof, ops: Tuple[str, ...]) -> Optional[Traced]:
    """None where the trace holds no window span."""
    events = prof.events()
    spans = [e for e in events if e.name == WINDOW_SPAN]
    if not spans:
        return None
    w0, w1 = spans[0].time_range.start, spans[0].time_range.end
    cuda = torch.autograd.DeviceType.CUDA
    kernels, cpu = [], []
    device = {}  # correlation id -> device seconds, the benchmark's spans left out
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if _span(e):
                continue
            device[e.id] = device.get(e.id, 0.0) + (t - s) * 1e-6
            if w0 <= s and t <= w1:
                kernels.append((s, t, e.name))
        elif w0 <= s <= w1 and e.name != WINDOW_SPAN:
            cpu.append((s, t, e.name))
    busy = _union([(s, t) for s, t, _ in kernels])
    op_s, op_n = {}, {}
    names = {op: sorted({e.name for e in events if op in e.name})[:8] for op in ops}
    for op in ops:
        hits = [e for e in events if _is_op(e.name, op) and w0 <= e.time_range.start <= w1]
        wrapped = [e for e in hits if e.name != op]
        hits = wrapped or hits
        op_n[op] = len(hits)
        op_s[op] = sum(device.get(i, 0.0) for e in hits for i in _launches(e))
    by_kernel: Dict[str, float] = {}
    for s, t, name in kernels:
        by_kernel[name] = by_kernel.get(name, 0.0) + (t - s) * 1e-6
    device_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    return Traced((w1 - w0) * 1e-6, sum(t - s for s, t in busy) * 1e-6, op_s, op_n, names,
                  [[n[:160], v] for n, v in device_ops], _gaps(busy, cpu, w0, w1), by_kernel)


def _span(e) -> bool:
    """A record_function span, mirrored on the device's timeline as an
    annotation: no activity of the device."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(SPAN_PREFIX)


def _launches(e) -> set:
    """Correlation ids of the runtime and driver calls (cuda*, cu*) made
    under CPU event `e`: the device work `e` launched. (The kernels the
    profiler itself links to an op, `FunctionEvent.kernels`, counted the
    fused op's kernels about twice under `torch.no_grad`.)"""
    ids, stack = set(), [e]
    while stack:
        x = stack.pop()
        for c in x.cpu_children:
            if c.name.startswith("cu"):
                ids.add(c.id)
            stack.append(c)
    return ids


def _gaps(busy, cpu, w0, w1) -> List[Tuple[str, float]]:
    """Idle time by what the host was doing when each gap began (the
    innermost CPU event open then; the latest-started that is open)."""
    cpu.sort()
    starts = [s for s, _, _ in cpu]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    by_name: Dict[str, float] = {}
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        name = "no host op"
        j = bisect.bisect_right(starts, g0) - 1
        for k in range(j, max(-1, j - 2000), -1):
            if cpu[k][1] >= g0:
                name = cpu[k][2]
                break
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) * 1e-6
    return [[n[:160], v] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
