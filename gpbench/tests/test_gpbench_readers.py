"""The per-layer readers on a made-up reading: a step's time is the
untraced window's, and only device seconds come from the trace; the
collectives' time is read from their kernels by name; each reader reads
the ops and the least work of the cell's model, and the GP-LVM's read what
they read before the model was chosen by the configuration."""
from types import SimpleNamespace as NS

import pytest
import torch

from gpbench import harness, trace, work

CUDA = torch.autograd.DeviceType.CUDA
SHAPE = {"N": 1_000_000, "M": 100, "Q": 1, "D": 3, "dtype": "float64"}
GPLVM = harness.model_of("BayesianGPLVM")
SGPR = harness.model_of("SparseGPRegression")
FWD, BWD = GPLVM.STATS_FWD_OP, GPLVM.STATS_BWD_OP


def _reading(validated=True, shape=SHAPE, kernel_s=None):
    # 40 traced steps of 42 ms (the profiler's host work), 26.5 ms busy
    # each; the kernels 8.5 and 16.6 ms a call; untraced, 32 ms a step
    t = trace.Traced(window_s=40 * 0.042, busy_s=40 * 0.0265,
                     op_device_s={FWD: 40 * 0.0085, BWD: 40 * 0.0166},
                     op_calls={FWD: 40, BWD: 40}, op_names={}, device_ops=[], idle_gaps=[],
                     kernel_s=kernel_s or {})
    return harness.Reading(t, 40, 0.032, shape, {FWD: validated, BWD: validated}, GPLVM)


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


# each reader's value on `_reading` at the paper's and the 2^24 shapes, as the
# readers gave them when they named the GP-LVM's ops and work themselves
BEFORE = {
    "float64": {"train_step_mfu": 10.073943147242646, "state_build_mfu": 2.877555759803922,
                "outside_stats_ms": 6.8999999999999995, "stats_fwd_roofline": 10.830449826989618,
                "stats_bwd_roofline": 13.864280652019845, "device_idle_share": 17.18749999999999,
                "allreduce_ms": 0.1},
    "float32": {"train_step_mfu": 210.24129782675234, "state_build_mfu": 105.12691766146312,
                "outside_stats_ms": 6.8999999999999995, "stats_fwd_roofline": 395.72467923441184,
                "stats_bwd_roofline": 202.63010683689765, "device_idle_share": 17.18749999999999,
                "allreduce_ms": 0.1},
}


@pytest.mark.parametrize("shape", [SHAPE, {"N": 16_777_216, "M": 128, "Q": 1, "D": 3,
                                           "dtype": "float32"}], ids=["paper", "2p24"])
def test_gplvm_readers_read_what_they_read_before(shape):
    r = _reading(shape=shape, kernel_s={"ncclDevKernel_AllReduce_Sum_f32_RING_LL": 0.004,
                                        "pair_kernel": 1.0})
    got = {name: _read(name, r) for name in BEFORE[shape["dtype"]]}
    assert got == BEFORE[shape["dtype"]]


def _sgpr_reading(validated=True):
    # 40 traced steps; a step's K_fu 0.4 ms forward and 0.5 ms back, the
    # two products 0.3 + 0.1 ms forward and 0.6 + 0.2 ms back; untraced,
    # 8 ms a step, 3 ms of it busy
    ops = {"_Kfu": (40, 0.0004), "_KfuBackward": (40, 0.0005),
           "_FullPrecisionMatmul": (80, 0.0004), "_FullPrecisionMatmulBackward": (80, 0.0008)}
    t = trace.Traced(window_s=40 * 0.012, busy_s=40 * 0.003,
                     op_device_s={op: 40 * s for op, (n, s) in ops.items()},
                     op_calls={op: n for op, (n, s) in ops.items()}, op_names={}, device_ops=[],
                     idle_gaps=[], kernel_s={})
    return harness.Reading(t, 40, 0.008, SHAPE, {op: validated for op in ops}, SGPR)


def test_sgpr_readers_read_its_ops_and_work():
    r = _sgpr_reading()
    assert _read("outside_stats_ms.sgpr", r) == pytest.approx(8 - 0.4 - 0.5 - 0.4 - 0.8)
    assert _read("device_idle_share.sgpr", r) == pytest.approx(100 * (1 - 3 / 8))
    step = work.bound_s(work.sgpr_train_step(*r.shapes()), "float64")
    assert _read("train_step_mfu.sgpr", r) == pytest.approx(100 * step / 0.008)
    fwd = work.bound_s(work.kfu_fwd(*r.shapes()), "float64")
    bwd = work.bound_s(work.kfu_bwd(*r.shapes()), "float64")
    assert _read("kfu_fwd_roofline.sgpr", r) == pytest.approx(100 * fwd / 0.0004)
    assert _read("kfu_bwd_roofline.sgpr", r) == pytest.approx(100 * bwd / 0.0005)


@pytest.mark.parametrize("name", ["outside_stats_ms.sgpr", "kfu_fwd_roofline.sgpr",
                                  "kfu_bwd_roofline.sgpr"])
def test_an_unvalidated_sgpr_op_reads_nothing(name):
    assert _read(name, _sgpr_reading(validated=False)) is None


@pytest.mark.parametrize("name", ["stats_fwd_roofline", "stats_bwd_roofline", "state_build_mfu"])
def test_a_reader_of_what_the_model_lacks_reads_nothing(name):
    """The regression has no B1, B2 or state build."""
    assert _read(name, _sgpr_reading()) is None
