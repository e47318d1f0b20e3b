"""The program's spans (`repro_torch.tracing`): under the profiler a
Bayesian GP-LVM training step opens each of its five spans once, nested as
the layers are, and a state build opens the statistics and the epilogue;
with the profiler off no `record_function` is entered at all."""
import numpy as np
import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch.gp import BayesianGPLVM

SPANS = ("repro_torch.forward", "repro_torch.backward", "repro_torch.stats",
         "repro_torch.epilogue", "repro_torch.adam")


def _model():
    Y = np.random.default_rng(0).normal(size=(64, 3))
    return BayesianGPLVM(M=8, Q=1, backend="fused", device="cpu"), Y


def _step_and_build(model, Y):
    """One Adam step through the facade, then a state build."""
    model.fit(Y, steps=1)
    return model.export_state()


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("repro_torch.")]


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_a_step_opens_each_span_once_nested_as_the_layers():
    model, Y = _model()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.fit(Y, steps=1)
    spans = _spans(prof)
    assert sorted(e.name for e in spans) == sorted(SPANS)
    by = {e.name: e for e in spans}
    for name in ("repro_torch.stats", "repro_torch.epilogue"):
        assert _inside(by[name], by["repro_torch.forward"]), name
    order = ["repro_torch.forward", "repro_torch.backward", "repro_torch.adam"]
    assert all(by[a].time_range.end <= by[b].time_range.start for a, b in zip(order, order[1:]))


def test_a_build_opens_the_statistics_and_the_epilogue_once():
    model, Y = _model()
    model.fit(Y, steps=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state = model.export_state()
    assert sorted(e.name for e in _spans(prof)) == ["repro_torch.epilogue", "repro_torch.stats"]
    assert torch.isfinite(state.Kuu_inv_mean).all()


@pytest.fixture
def entered(monkeypatch):
    """The names `record_function` is entered with, counted by a stand-in
    that still opens the real range."""
    names, real = [], profiler.record_function

    def counting(name, *args, **kwargs):
        names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(profiler, "record_function", counting)
    return names


def test_no_record_function_while_the_profiler_is_off(entered):
    model, Y = _model()
    assert not profiler._is_profiler_enabled
    _step_and_build(model, Y)
    assert entered == []


def test_the_stand_in_counts_while_the_profiler_is_on(entered):
    model, Y = _model()
    with profile(activities=[ProfilerActivity.CPU]):
        _step_and_build(model, Y)
    program = [n for n in entered if n.startswith("repro_torch.")]
    assert sorted(program) == sorted(SPANS + ("repro_torch.stats", "repro_torch.epilogue"))
