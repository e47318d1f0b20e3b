"""The per-layer readers on a made-up reading: a step's time is the
untraced window's, and only device seconds come from the trace; the
collectives' time is read from their kernels by name."""
from types import SimpleNamespace as NS

import pytest
import torch

from gpbench import harness, program, trace, work

CUDA = torch.autograd.DeviceType.CUDA
SHAPE = {"N": 1_000_000, "M": 100, "Q": 1, "D": 3, "dtype": "float64"}
FWD, BWD = program.STATS_FWD_OP, program.STATS_BWD_OP


def _reading(validated=True):
    # 40 traced steps of 42 ms (the profiler's host work), 26.5 ms busy
    # each; the kernels 8.5 and 16.6 ms a call; untraced, 32 ms a step
    t = trace.Traced(window_s=40 * 0.042, busy_s=40 * 0.0265,
                     op_device_s={FWD: 40 * 0.0085, BWD: 40 * 0.0166},
                     op_calls={FWD: 40, BWD: 40}, op_names={}, device_ops=[], idle_gaps=[],
                     kernel_s={})
    return harness.Reading(t, 40, 0.032, SHAPE, {FWD: validated, BWD: validated})


def _read(name, reading):
    return harness.load_reader({"name": name}).read(reading)


def test_step_time_is_the_untraced_one():
    r = _reading()
    assert _read("outside_stats_ms.paper", r) == pytest.approx(32 - 8.5 - 16.6)
    assert _read("device_idle_share.paper", r) == pytest.approx(100 * (1 - 26.5 / 32))
    bound = work.bound_s(work.train_step(*r.shapes()), "float64")
    assert _read("train_step_mfu.paper", r) == pytest.approx(100 * bound / 0.032)


def test_rooflines_read_the_traced_kernels():
    r = _reading()
    fwd = work.bound_s(work.stats_fwd(*r.shapes()), "float64")
    bwd = work.bound_s(work.stats_bwd(*r.shapes()), "float64")
    assert _read("stats_fwd_roofline.fit", r) == pytest.approx(100 * fwd / 0.0085)
    assert _read("stats_bwd_roofline", r) == pytest.approx(100 * bwd / 0.0166)


@pytest.mark.parametrize("name", ["outside_stats_ms", "stats_fwd_roofline.build",
                                  "stats_bwd_roofline.paper"])
def test_an_unvalidated_op_reads_nothing(name):
    assert _read(name, _reading(validated=False)) is None


def test_a_reader_is_found_by_the_name_before_the_first_dot(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "x_ms.py").write_text("def read(r):\n    return 7\n")
    assert harness.load_reader({"name": "x_ms.special"}, tmp_path).read(None) == 7


def _kernel(name, start, end, id):
    return NS(name=name, time_range=NS(start=start, end=end), device_type=CUDA, id=id,
              cpu_children=[], is_user_annotation=False)


def test_allreduce_reads_the_collectives_kernels_waits_included():
    """On a made-up trace of two steps: each all-reduce kernel's whole
    duration counts (it runs until the slowest rank's share arrives), one
    before the window does not, and no other kernel does."""
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    events = [NS(name=trace.WINDOW_SPAN, time_range=NS(start=0, end=20_000),
                 device_type=torch.autograd.DeviceType.CPU, id=0, cpu_children=[]),
              _kernel(nccl, -500, -100, 1), _kernel("pair_kernel", 100, 9_000, 2),
              _kernel(nccl, 9_100, 9_400, 3), _kernel("pair_kernel", 10_000, 19_000, 4),
              _kernel(nccl, 19_100, 19_200, 5)]
    t = trace.summarize(NS(events=lambda: events), ())
    assert t.kernel_s[nccl] == pytest.approx(400e-6)
    r = _reading()._replace(traced=t, done=2)
    assert _read("allreduce_ms", r) == pytest.approx(0.2)


def test_allreduce_reads_nothing_without_collectives():
    """One card: the trace holds no collective's kernel."""
    r = _reading()
    assert _read("allreduce_ms", r) is None
    t = r.traced._replace(kernel_s={"pair_kernel": 1.0, "psi2_partial_kernel": 0.5})
    assert _read("allreduce_ms", r._replace(traced=t)) is None
