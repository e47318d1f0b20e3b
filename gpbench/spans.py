"""The program's own spans, read from a cell's trace: where each device
second, device operation, blocking call and idle gap of the traced window
falls among the layers of `repro_torch`.

`attribute(events, busy_s)` reads the events of a `--trace 1` run's
profiler (`gpbench.trace.profiling`) and `report` prints, for each span in
SPANS (opened by `repro_torch.tracing.span`), a step's or build's entries,
device ms, device operations launched, blocking calls and idle ms; where
each blocking call was made; and the check that every busy second of the
window was put down once. The trace is one clock for the host's spans and
the device's activity, so:

  * a runtime or driver call (`cuda*`, `cu*`) belongs to the innermost
    span whose interval holds its start, on any thread: on CUDA the autograd
    engine runs the reverse pass on a thread of its own while the main
    thread waits inside `repro_torch.backward`;
  * a device activity (kernel, copy, set) belongs to the span of the call
    that launched it (by correlation id), to OUTSIDE the program where that
    call was made outside every span, or to UNLINKED where no call in the
    trace has its id;
  * an idle gap belongs to the innermost span open when it began. The
    profiler slows the host's work, so idle time read here is biased
    upward: it is reported, not a metric.

The check holds the device seconds put down to spans and OUTSIDE against
the window's busy seconds as `gpbench.trace.summarize` reads them (the
union of the activities' intervals, with no correlation ids), and fails
on any UNLINKED second.
"""
from __future__ import annotations

import bisect
from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Tuple

SPANS = ("repro_torch.forward", "repro_torch.stats", "repro_torch.epilogue",
         "repro_torch.backward", "repro_torch.adam")
OUTSIDE = "outside the program"
UNLINKED = "no launching call"
# the runtime calls that hold the host until the device has caught up
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
            "cudaMemcpy")
# one of these benchmark spans (`gpbench/models/`) wraps each step or build
ITEM_SPANS = ("gpbench.adam", "gpbench.build_state")
AGREE = 1e-3  # the device seconds put down, against the window's busy ones, at most this apart


class SpanTrace(NamedTuple):
    items: int  # steps or builds in the window
    calls: Dict[str, int]  # span -> entries in the window
    device_s: Dict[str, float]  # span, OUTSIDE or UNLINKED -> device seconds
    launches: Dict[str, int]  # span, OUTSIDE or UNLINKED -> device operations launched
    syncs: Dict[str, int]  # span or OUTSIDE -> blocking calls
    sync_sites: Dict[str, int]  # "span: op > op > call" -> blocking calls made there
    idle_s: Dict[str, float]  # span or OUTSIDE -> idle seconds (profiler-biased)
    elsewhere: Dict[str, int]  # span -> its runtime calls made outside its own ops
    busy_s: float  # the window's busy seconds, from `trace.summarize`

    def accounted(self) -> float:
        """The device seconds put down to a span or OUTSIDE, over the
        window's busy seconds (1 where each is put down once)."""
        put = sum(v for k, v in self.device_s.items() if k != UNLINKED)
        return put / self.busy_s if self.busy_s else 1.0

    def sound(self) -> bool:
        """Every busy second put down once, and none without its call."""
        return not self.device_s.get(UNLINKED) and abs(self.accounted() - 1) <= AGREE

    def per_item(self, table: dict, span: str) -> float:
        return table.get(span, 0) / self.items if self.items else 0.0


def _innermost(intervals: List[Tuple[float, float, str]]):
    """time -> the innermost (last opened) of `intervals` (start, end, name)
    open then, or None."""
    intervals = sorted((iv for iv in intervals if iv[1] > iv[0]), key=lambda iv: (iv[0], -iv[1]))
    edges = sorted([(iv[0], 1, i) for i, iv in enumerate(intervals)]
                   + [(iv[1], 0, i) for i, iv in enumerate(intervals)])
    times, labels, open_ = [], [], set()
    for t, opens, i in edges:
        (open_.add if opens else open_.discard)(i)
        times.append(t)
        labels.append(intervals[max(open_)] if open_ else None)

    def at(t: float):
        j = bisect.bisect_right(times, t) - 1
        return labels[j] if j >= 0 else None

    return at


def _parents(e):
    x = getattr(e, "cpu_parent", None)
    while x is not None:
        yield x
        x = getattr(x, "cpu_parent", None)


def _site(e, depth: int = 3) -> str:
    """The call and the ops it was made under, outermost first, up to
    `depth` ops and below any span."""
    names = [e.name]
    for x in _parents(e):
        if len(names) > depth or x.name.startswith(("repro_torch.", "gpbench.")):
            break
        names.append(x.name)
    return " > ".join(reversed(names))


def attribute(events, busy_s: float, spans=SPANS) -> Optional[SpanTrace]:
    """The window's device time, operations, blocking calls and idle gaps by
    program span, `busy_s` being `trace.summarize`'s reading of the same
    events; None where the trace holds no window span."""
    import torch

    from gpbench import trace

    cuda = torch.autograd.DeviceType.CUDA
    events = list(events)
    window = [e for e in events if e.name == trace.WINDOW_SPAN]
    if not window:
        return None
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    inside = lambda e: w0 <= e.time_range.start <= w1  # noqa: E731
    cpu = [e for e in events if e.device_type != cuda]
    owned = [(e.time_range.start, e.time_range.end, e.name) for e in cpu if e.name in spans]
    owner = _innermost(owned)
    name_of = lambda iv: iv[2] if iv else OUTSIDE  # noqa: E731
    calls = {s: sum(1 for e in cpu if e.name == s and inside(e)) for s in spans}
    items = sum(1 for e in cpu if e.name in ITEM_SPANS and inside(e))
    launched_by, syncs, sites, elsewhere = {}, Counter(), Counter(), Counter()
    for e in cpu:
        if not e.name.startswith("cu"):
            continue
        iv = owner(e.time_range.start)
        launched_by[e.id] = name_of(iv)
        if iv is not None and inside(e) and all(x.name != iv[2] for x in _parents(e)):
            elsewhere[iv[2]] += 1
        if e.name in BLOCKING and inside(e):
            syncs[name_of(iv)] += 1
            sites[f"{name_of(iv)}: {_site(e)}"] += 1
    device_s, launches, idle, busy = Counter(), Counter(), Counter(), []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type != cuda or trace._span(e) or not (w0 <= s and t <= w1):
            continue
        by = launched_by.get(e.id, UNLINKED)
        device_s[by] += (t - s) * 1e-6
        launches[by] += 1
        busy.append((s, t))
    edge = w0
    for s, t in sorted(busy) + [(w1, w1)]:
        if s > edge:
            idle[name_of(owner(edge))] += (s - edge) * 1e-6
        edge = max(edge, t)
    return SpanTrace(items, calls, dict(device_s), dict(launches), dict(syncs), dict(sites),
                     dict(idle), dict(elsewhere), busy_s)


def report(st: SpanTrace, spans=SPANS) -> List[str]:
    """The per-span table of a step or build, the blocking calls' sites, the
    values the span metrics would read, and the check that every busy
    second was put down once."""
    rows = [f"spans: {st.items} items; a step's or build's entries, device ms, device "
            "operations, blocking calls, idle ms (profiler-biased); runtime calls in the "
            "window made outside the span's own ops (another thread's)"]
    for span in spans + (OUTSIDE, UNLINKED):
        rows.append(
            f"span {span}: {st.per_item(st.calls, span):.3f} entries, "
            f"{1e3 * st.per_item(st.device_s, span):.4f} ms device, "
            f"{st.per_item(st.launches, span):.2f} operations, "
            f"{st.per_item(st.syncs, span):.3f} blocking, "
            f"{1e3 * st.per_item(st.idle_s, span):.4f} ms idle, "
            f"{st.elsewhere.get(span, 0)} calls made outside its ops")
    for where, n in sorted(st.sync_sites.items(), key=lambda kv: -kv[1]):
        rows.append(f"blocking call at {where}: {n} ({n / max(st.items, 1):.3f} an item)")
    ops = sum(st.launches.get(s, 0) for s in spans)
    syncs = sum(st.syncs.get(s, 0) for s in spans)
    rows.append(
        f"would read: launches_per_step {ops / max(st.items, 1):.3f}, "
        f"host_syncs_per_step {syncs / max(st.items, 1):.3f}, "
        f"adam_device_ms {1e3 * st.per_item(st.device_s, 'repro_torch.adam'):.4f}, "
        f"epilogue_device_ms {1e3 * st.per_item(st.device_s, 'repro_torch.epilogue'):.4f}")
    rows.append(f"attribution check: {st.accounted() * st.busy_s:.6f} s put down to spans and "
                f"outside, of the window's {st.busy_s:.6f} busy seconds "
                f"({100 * (st.accounted() - 1):+.4f} %), "
                f"{st.device_s.get(UNLINKED, 0.0):.6f} s unlinked: "
                f"{'every second once' if st.sound() else 'FAILED'}")
    return rows

