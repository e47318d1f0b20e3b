"""Faults planted under the timed path, to show that the check catches
them: the benchmark's own runs never plant one. Each is a context manager
around a run (`harness.run`), or, for `unchanged`, a wrapper of the
program (`plant=`).

  * `half_batch`: the statistics op sees only the first half of the points
    and doubles what it sums (the mean taken over the rest); its reverse
    gives the left-out points no gradient;
  * `altered`: one entry of psi2 is wrong where the forward op produces it;
  * `unchanged`: the training step returns the parameters it was given.

On several cards (`RANK_FAULTS`), in the program's all-reduce of the
statistics (`core.distributed._AllReduceSum`):

  * `left_out`: the last rank's statistics left out of the sum (the
    exchange with one card left out);
  * `twice`: the statistics' cotangents summed over the ranks on the way
    back too, as `torch.distributed.nn`'s `all_reduce` would, so that the
    globals' cotangents are summed twice.

`control` puts the reference in the program's place, computed one
precision below the configuration's (float32 for float64; TF32 for
float32, whose products the program runs in full float32). For a float32
configuration two more lower-precision references give upper readings
where TF32's K_uu fails its Cholesky and so reads no number:
`CONTROLS["control-refold"]` (the refold's factorizations and solves in
TF32) and `CONTROLS["control-stats"]` (the statistics in bfloat16).

On several cards the control runs on every rank over the whole problem, as
one card would, and each rank hands the harness its own rows.

The op's kernels are looked up in `repro_torch.kernels.ops`'s namespace at
each call, so replacing them there reaches the card's kernels and the CPU's
plain versions alike.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_FWD = ("suffstats_cuda", "suffstats_fused_plain")
_BWD = ("suffstats_bwd_cuda", "suffstats_vjp_plain")


@contextlib.contextmanager
def _patched(make_fwd=None, make_bwd=None):
    from repro_torch.kernels import ops

    saved = {k: getattr(ops, k) for k in _FWD + _BWD}
    try:
        for k in _FWD:
            if make_fwd:
                setattr(ops, k, make_fwd(saved[k]))
        for k in _BWD:
            if make_bwd:
                setattr(ops, k, make_bwd(saved[k]))
        yield
    finally:
        for k, v in saved.items():
            setattr(ops, k, v)


def half_batch():
    def fwd(orig):
        def f(mu, S, Y, Z, v, l, **kw):
            h = mu.shape[0] // 2
            psi2, psiY = orig(mu[:h], S[:h], Y[:h], Z, v, l, **kw)
            return 2 * psi2, 2 * psiY
        return f

    def bwd(orig):
        def f(mu, S, Y, Z, v, l, g2, gY, **kw):
            h = mu.shape[0] // 2
            dmu, dS, dY, dZ, dv, dl = orig(mu[:h], S[:h], Y[:h], Z, v, l, 2 * g2, 2 * gY, **kw)

            def pad(t, like):
                return torch.cat([t, torch.zeros_like(like[h:])])
            return pad(dmu, mu), pad(dS, S), pad(dY, Y), dZ, dv, dl
        return f

    return _patched(fwd, bwd)


def altered(factor: float = 1.5):
    def fwd(orig):
        def f(*args, **kw):
            psi2, psiY = orig(*args, **kw)
            psi2 = psi2.clone()
            psi2[0, 0] = psi2[0, 0] * factor
            return psi2, psiY
        return f

    return _patched(fwd, None)


def unchanged(prog):
    """`prog` with a training step that returns its parameters unchanged."""
    step = prog.train_step

    def train_step(params, opt, Y):
        _, opt, value = step(params, opt, Y)
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


FAULTS = {"half": half_batch, "alter": altered}
RANK_FAULTS = {"left-out": left_out, "twice": twice}


LOWER = {"float64": "float32", "float32": "tf32"}


class Control:
    """The reference at a precision below the configuration's (by default
    the one just below), with the program's interface."""

    def __init__(self, prog, precision=None):
        from gpbench import problem
        from gpbench.reference import gplvm as reference

        if precision is not None and prog.dtype != "float32":
            raise ValueError(f"{precision!r} lowers float32; the configuration is {prog.dtype}")
        self.ref = reference
        self.num = reference.Numerics.of(precision or LOWER[prog.dtype],
                                         problem.DTYPES[prog.dtype])
        self.lr = prog.adam.lr
        self.local_keys = prog.local_keys

    def place(self, params, Y):
        return params, Y

    def adam_init(self, params):
        return self.ref.adam_init(self.ref.cast(params, self.num.dtype))

    def train_step(self, params, opt, Y):
        loss, grads = self.ref.value_and_grad(params, Y, self.num)
        params, opt = self.ref.adam_update(grads, opt, self.ref.cast(params, self.num.dtype), self.lr)
        return params, opt, loss

    def build(self, params, Y):
        return self.ref.build(params, Y, self.num)


class ControlOnRanks(Control):
    """The control in a cell on several cards: every rank runs the
    reference over the whole problem, and hands the harness its own rows
    of it, as the program's ranks do."""

    def place(self, params, Y):
        r, W, N = dist.get_rank(), dist.get_world_size(), Y.shape[0]
        self.rows = slice(N * r // W, N * (r + 1) // W)
        self.whole = (self.ref.cast(params, self.num.dtype), Y)
        return self._own(params), Y[self.rows]

    def _own(self, tree):
        return {k: v[self.rows] if k in self.local_keys else v for k, v in tree.items()}

    def adam_init(self, params):
        self.opt = super().adam_init(self.whole[0])
        return self.opt

    def train_step(self, params, opt, Y):
        p, self.opt, loss = super().train_step(self.whole[0], self.opt, self.whole[1])
        self.whole = (p, self.whole[1])
        return self._own(p), self.opt._replace(m=self._own(self.opt.m)), loss


def _control(precision=None):
    def plant(prog):
        return (Control if prog.mesh is None else ControlOnRanks)(prog, precision)
    return plant


control = _control()
CONTROLS = {"control": control,
            "control-refold": _control("tf32-refold"),
            "control-stats": _control("bf16-stats")}


def planted(mode: str):
    """(a context around the run, a wrapper of the program or None) of a
    reading's mode: "program", a control, or a planted fault."""
    faults = dict(FAULTS, **RANK_FAULTS)
    context = faults[mode]() if mode in faults else contextlib.nullcontext()
    return context, dict(CONTROLS, unchanged=unchanged).get(mode)
