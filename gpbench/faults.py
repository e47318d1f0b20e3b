"""Faults planted under the timed path, to show that the check catches
them: the benchmark's own runs never plant one. Each is a context manager
around a run (`harness.run`), or, for `unchanged` and the controls, a
wrapper of the program (`plant=`).

The faults of one model's statistics ops (`half`, `alter`) are its
module's `FAULTS` (`gpbench/models/`); `patched` replaces an op's kernels
for them. Those of any model:

  * `unchanged`: the training step returns the parameters it was given.

On several cards (`RANK_FAULTS`), in the program's all-reduce of the
statistics (`core.distributed._AllReduceSum`):

  * `left_out`: the last rank's statistics left out of the sum (the
    exchange with one card left out);
  * `twice`: the statistics' cotangents summed over the ranks on the way
    back too, as `torch.distributed.nn`'s `all_reduce` would, so that the
    globals' cotangents are summed twice.

`control` puts the model's reference in the program's place, computed one
precision below the configuration's (float32 for float64; TF32 for
float32, whose products the program runs in full float32). For a float32
configuration two more lower-precision references give upper readings
where TF32's K_uu fails its Cholesky and so reads no number:
`CONTROLS["control-refold"]` (the refold's factorizations and solves in
TF32) and `CONTROLS["control-stats"]` (the statistics in bfloat16).

On several cards the control runs on every rank over the whole problem, as
one card would, and each rank hands the harness its own rows.

The ops' kernels are looked up in `repro_torch.kernels.ops`'s namespace at
each call, so replacing them there reaches the card's kernels and the CPU's
plain versions alike.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from gpbench import problem


@contextlib.contextmanager
def patched(fwd_names, bwd_names, make_fwd=None, make_bwd=None):
    """Inside the block, each kernel of `repro_torch.kernels.ops` named in
    `fwd_names` is `make_fwd(the kernel)`, and each in `bwd_names`
    `make_bwd(the kernel)`; None leaves them as they are."""
    from repro_torch.kernels import ops

    saved = {k: getattr(ops, k) for k in tuple(fwd_names) + tuple(bwd_names)}
    try:
        for names, make in ((fwd_names, make_fwd), (bwd_names, make_bwd)):
            for k in names:
                if make:
                    setattr(ops, k, make(saved[k]))
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def unchanged(prog, model=None):
    """`prog` with a training step that returns its parameters unchanged."""
    step = prog.train_step

    def train_step(params, opt, data):
        _, opt, value = step(params, opt, data)
        return params, opt, value

    prog.train_step = train_step
    return prog


@contextlib.contextmanager
def _collective(forward=None, backward=None):
    from repro_torch.core import distributed

    fn = distributed._AllReduceSum
    saved = fn.forward, fn.backward
    try:
        if forward:
            fn.forward = staticmethod(forward(saved[0]))
        if backward:
            fn.backward = staticmethod(backward(saved[1]))
        yield
    finally:
        fn.forward, fn.backward = staticmethod(saved[0]), staticmethod(saved[1])


def left_out():
    def forward(orig):
        def f(ctx, flat, group):
            last = dist.get_rank(group) == dist.get_world_size(group) - 1
            return orig(ctx, torch.zeros_like(flat) if last else flat, group)
        return f

    return _collective(forward, None)


def twice():
    def forward(orig):
        def f(ctx, flat, group):
            ctx.group = group
            return orig(ctx, flat, group)
        return f

    def backward(orig):
        def f(ctx, g):
            g = g.clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
            return orig(ctx, g)
        return f

    return _collective(forward, backward)


RANK_FAULTS = {"left-out": left_out, "twice": twice}


LOWER = {"float64": "float32", "float32": "tf32"}


class Control:
    """The model's reference at a precision below the configuration's (by
    default the one just below), with the program's interface."""

    def __init__(self, prog, model, precision=None):
        if precision is not None and prog.dtype != "float32":
            raise ValueError(f"{precision!r} lowers float32; the configuration is {prog.dtype}")
        self.ref = model.reference
        self.num = self.ref.Numerics.of(precision or LOWER[prog.dtype],
                                        problem.DTYPES[prog.dtype])
        self.lr = prog.adam.lr
        self.local_keys = prog.local_keys

    def place(self, params, data):
        return params, data

    def adam_init(self, params):
        return self.ref.adam_init(self.ref.cast(params, self.num.dtype))

    def train_step(self, params, opt, data):
        loss, grads = self.ref.value_and_grad(params, *data, self.num)
        params, opt = self.ref.adam_update(grads, opt, self.ref.cast(params, self.num.dtype),
                                           self.lr)
        return params, opt, loss

    def build(self, params, data):
        return self.ref.build(params, *data, self.num)


class ControlOnRanks(Control):
    """The control in a cell on several cards: every rank runs the
    reference over the whole problem, and hands the harness its own rows
    of it, as the program's ranks do."""

    def place(self, params, data):
        r, W, N = dist.get_rank(), dist.get_world_size(), data[0].shape[0]
        self.rows = slice(N * r // W, N * (r + 1) // W)
        self.whole = (self.ref.cast(params, self.num.dtype), data)
        return self._own(params), tuple(x[self.rows] for x in data)

    def _own(self, tree):
        return {k: v[self.rows] if k in self.local_keys else v for k, v in tree.items()}

    def adam_init(self, params):
        self.opt = super().adam_init(self.whole[0])
        return self.opt

    def train_step(self, params, opt, data):
        p, self.opt, loss = super().train_step(self.whole[0], self.opt, self.whole[1])
        self.whole = (p, self.whole[1])
        return self._own(p), self.opt._replace(m=self._own(self.opt.m)), loss


def _control(precision=None):
    def plant(prog, model):
        return (Control if prog.mesh is None else ControlOnRanks)(prog, model, precision)
    return plant


control = _control()
CONTROLS = {"control": control,
            "control-refold": _control("tf32-refold"),
            "control-stats": _control("bf16-stats")}


def planted(mode: str, model):
    """(a context around the run, a wrapper `plant(prog, model)` of the
    program or None) of a reading's mode: "program", a control, or a
    planted fault of the model or of several cards."""
    faults = dict(model.FAULTS, **RANK_FAULTS)
    if mode not in faults and mode not in CONTROLS and mode not in ("program", "unchanged"):
        raise KeyError(f"mode {mode!r}: {model.__name__} has no such fault")
    context = faults[mode]() if mode in faults else contextlib.nullcontext()
    return context, dict(CONTROLS, unchanged=unchanged).get(mode)
