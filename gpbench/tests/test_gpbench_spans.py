"""The program's spans read from a trace (`gpbench/spans.py`): on made-up
events, where each device second, operation, blocking call and idle gap
is put down, and that the check fails where a second is put down twice or
not at all; and on the CPU, the profiler's own events of the benchmark's
step and build hold each span once an item."""
from types import SimpleNamespace as NS

import pytest
import torch
from torch.profiler import record_function

from gpbench import harness, spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
FWD, STATS, EPI, BWD, ADAM = spans.SPANS
OUT, UNLINKED = spans.OUTSIDE, spans.UNLINKED


def _ev(name, start, end, parent=None, device=CPU, id=0, thread=1, annotation=False):
    return NS(name=name, time_range=NS(start=start, end=end), cpu_parent=parent,
              device_type=device, id=id, thread=thread, is_user_annotation=annotation)


def _step():
    """One training step in a window of 1000 us: the statistics, the
    epilogue and the loss's own kernel in the forward; the reverse pass's
    kernel launched from the autograd engine's thread while the main thread
    waits in the backward span; Adam's copy, its synchronization and a
    kernel; a kernel the benchmark launches outside the program; a range
    mirrored on the device; and a kernel before the window."""
    window = _ev("gpbench.window", 0, 1000)
    fwd, stats, epi = _ev(FWD, 10, 300), _ev(STATS, 20, 150), _ev(EPI, 160, 280)
    bwd, adam = _ev(BWD, 300, 600), _ev(ADAM, 610, 890)
    mul = _ev("aten::mul", 25, 145, stats)
    to = _ev("aten::to", 615, 640, adam)
    copy = _ev("aten::copy_", 616, 639, to)
    engine = _ev("autograd::engine::evaluate_function: _SuffStatsBackward", 340, 580, thread=2)
    calls = [_ev("cudaLaunchKernel", 30, 31, mul, id=1),
             _ev("cudaLaunchKernel", 170, 171, epi, id=2),
             _ev("cudaLaunchKernel", 290, 291, fwd, id=3),
             _ev("cuLaunchKernel", 350, 351, engine, id=4, thread=2),
             _ev("cudaMemcpyAsync", 620, 621, copy, id=5),
             _ev("cudaStreamSynchronize", 623, 638, copy, id=6),
             _ev("cudaLaunchKernel", 700, 701, adam, id=7),
             _ev("cudaLaunchKernel", 950, 951, id=8),
             _ev("cudaLaunchKernel", -50, -49, id=9)]
    device = [_ev("psi2_partial_kernel", 40, 140, device=CUDA, id=1),
              _ev("elementwise_kernel", 175, 200, device=CUDA, id=2),
              _ev("reduce_kernel", 295, 298, device=CUDA, id=3),
              _ev("pair_kernel", 360, 560, device=CUDA, id=4),
              _ev("Memcpy HtoD (Pageable -> Device)", 621, 622, device=CUDA, id=5),
              _ev("adam_kernel", 705, 710, device=CUDA, id=7),
              _ev("isfinite_kernel", 955, 960, device=CUDA, id=8),
              _ev("early_kernel", -40, -30, device=CUDA, id=9),
              _ev(STATS, 40, 140, device=CUDA, id=1, annotation=True)]
    items = [_ev("gpbench.loss_and_grad", 5, 605), _ev("gpbench.adam", 605, 900)]
    return [window, fwd, stats, epi, bwd, adam, mul, to, copy, engine, *items, *calls, *device]


def _attribute(events):
    """`spans.attribute` with the busy seconds `trace.summarize` reads."""
    return spans.attribute(events, trace.summarize(NS(events=lambda: events), ()).busy_s)


def test_device_time_and_operations_go_to_the_launching_span():
    st = _attribute(_step())
    us = {STATS: 100, EPI: 25, FWD: 3, BWD: 200, ADAM: 6, OUT: 5}
    assert st.device_s == pytest.approx({k: v * 1e-6 for k, v in us.items()})
    assert st.launches == {STATS: 1, EPI: 1, FWD: 1, BWD: 1, ADAM: 2, OUT: 1}
    assert st.items == 1 and st.calls == {s: 1 for s in spans.SPANS}


def test_a_call_on_another_thread_belongs_to_the_span_open_then():
    """The reverse pass's launch is no child of the backward span's event,
    yet it falls inside its interval."""
    st = _attribute(_step())
    assert st.device_s[BWD] == pytest.approx(200e-6)
    assert st.elsewhere == {BWD: 1}


def test_blocking_calls_are_counted_where_they_are_made():
    st = _attribute(_step())
    assert st.syncs == {ADAM: 1}
    assert st.sync_sites == {f"{ADAM}: aten::to > aten::copy_ > cudaStreamSynchronize": 1}


def test_every_device_second_in_the_window_is_put_down_once():
    st = _attribute(_step())
    assert st.busy_s == pytest.approx(339e-6)
    assert st.accounted() == pytest.approx(1.0) and st.sound()
    assert "every second once" in spans.report(st)[-1]


def test_a_kernel_no_call_launched_fails_the_check():
    st = _attribute(_step() + [_ev("stray_kernel", 800, 840, device=CUDA, id=99)])
    assert st.device_s[UNLINKED] == pytest.approx(40e-6) and st.launches[UNLINKED] == 1
    assert st.busy_s == pytest.approx(379e-6)
    assert not st.sound()
    assert spans.report(st)[-1].endswith("FAILED")


def test_a_second_put_down_twice_fails_the_check():
    """Two activities of one call over the same interval: their seconds
    sum above the window's busy ones."""
    st = _attribute(_step() + [_ev("twin_kernel", 40, 140, device=CUDA, id=1)])
    assert st.device_s[STATS] == pytest.approx(200e-6)
    assert st.busy_s == pytest.approx(339e-6)
    assert st.accounted() > 1 + spans.AGREE and not st.sound()


def test_idle_gaps_go_to_the_innermost_span_open_when_they_began():
    st = _attribute(_step())
    us = {OUT: 40 + 40, STATS: 35, EPI: 95, FWD: 62, BWD: 61, ADAM: 83 + 245}
    assert st.idle_s == pytest.approx({k: v * 1e-6 for k, v in us.items()})
    assert sum(st.idle_s.values()) + st.busy_s == pytest.approx(1000e-6)


def test_the_metrics_it_would_read():
    row = spans.report(_attribute(_step()))[-2]
    assert row == ("would read: launches_per_step 6.000, host_syncs_per_step 1.000, "
                   "adam_device_ms 0.0060, epilogue_device_ms 0.0250")


def test_innermost_of_nested_ranges_with_one_start():
    at = spans._innermost([(0, 10, "outer"), (0, 5, "inner"), (7, 7, "empty")])
    names = [at(t)[2] if at(t) else None for t in (-1, 0, 4, 6, 7, 10.5)]
    assert names == [None, "inner", "inner", "outer", "outer", None]


def test_no_window_reads_nothing():
    assert spans.attribute([_ev(FWD, 0, 1)], 0.0) is None


@pytest.mark.parametrize("kind,entered", [
    ("train", {s: 1 for s in spans.SPANS}),
    ("build", {FWD: 0, STATS: 1, EPI: 1, BWD: 0, ADAM: 0}),
])
def test_the_benchmarks_step_and_build_open_each_span_once_an_item(kind, entered):
    """Two steps or builds of the paper cell's configuration at a small
    size, in a window under the benchmark's profiler."""
    cell = harness.load_cell("gplvm-paper.fit")
    shape = dict(cell.config, N=500, M=8)
    prog = cell.model.Program(shape, lr=1e-2, device="cpu")
    params, data = cell.model.draw(shape, 5, "cpu")
    opt = prog.adam_init(params)
    with trace.profiling() as holder:
        with record_function(trace.WINDOW_SPAN):
            for _ in range(2):
                if kind == "train":
                    params, opt, _ = prog.train_step(params, opt, data)
                else:
                    prog.build(params, data)
    st = spans.attribute(holder[0].events(), trace.summarize(holder[0], ()).busy_s)
    assert st.items == 2
    assert {s: n / st.items for s, n in st.calls.items()} == entered
    assert st.device_s == {} and st.sound()
