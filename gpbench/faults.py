"""Faults planted under the timed path, to show that the check catches
them: the benchmark's own runs never plant one. Each is a context manager
around a run (`harness.run`), or, for `unchanged`, a wrapper of the
program (`plant=`).

  * `half_batch`: the statistics op sees only the first half of the points
    and doubles what it sums (the mean taken over the rest); its reverse
    gives the left-out points no gradient;
  * `altered`: one entry of psi2 is wrong where the forward op produces it;
  * `unchanged`: the training step returns the parameters it was given.

`control` puts the reference in the program's place, computed one
precision below the configuration's (float32 for float64; TF32 for
float32, whose products the program runs in full float32). For a float32
configuration two more lower-precision references give upper readings
where TF32's K_uu fails its Cholesky and so reads no number:
`CONTROLS["control-refold"]` (the refold's factorizations and solves in
TF32) and `CONTROLS["control-stats"]` (the statistics in bfloat16).

The op's kernels are looked up in `repro_torch.kernels.ops`'s namespace at
each call, so replacing them there reaches the card's kernels and the CPU's
plain versions alike.
"""
from __future__ import annotations

import contextlib

import torch

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


FAULTS = {"half": half_batch, "alter": altered}


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

    def adam_init(self, params):
        return self.ref.adam_init(self.ref.cast(params, self.num.dtype))

    def train_step(self, params, opt, Y):
        loss, grads = self.ref.value_and_grad(params, Y, self.num)
        params, opt = self.ref.adam_update(grads, opt, self.ref.cast(params, self.num.dtype), self.lr)
        return params, opt, loss

    def build(self, params, Y):
        return self.ref.build(params, Y, self.num)


def control(prog):
    return Control(prog)


CONTROLS = {"control": control,
            "control-refold": lambda prog: Control(prog, "tf32-refold"),
            "control-stats": lambda prog: Control(prog, "bf16-stats")}
