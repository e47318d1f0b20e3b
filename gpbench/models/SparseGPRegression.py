"""Sparse GP regression with an RBF kernel on the collapsed (Titsias)
bound, as the `repro_torch` facade (`SparseGPRegression`) runs it, driven
by the benchmark's loop so that a window ends on time.

A training step is `core.inference.fit_adam`'s: `value_and_grad` of the
facade's own `_loss` (`SparseGPRegression._loss`: the exact statistics
through the configured backend, K_uu and `svgp.collapsed_bound`), then
`optim.adam_update`. With `backend="pallas"` the statistics are
`core.psi_stats.exact_stats_rbf`'s: K_fu through its op (`kernels.ops.kfu`:
B7 forward, B6 at S = 0 back) and psi2 = K_fu^T K_fu and psiY = K_fu^T Y
as two products in full precision (`psi_stats._FullPrecisionMatmul`). One
card only. The data is `(X, Y)`; the reference is
`gpbench/reference/sgpr.py`.

Faults planted under K_fu's op (`FAULTS`):

  * `half_batch`: the forward computes the rows of the first half of the
    points only and repeats them for the rest, so psi2 is the first half's
    mean taken over all N; its reverse gives the left-out points no
    gradient;
  * `altered`: B6's cotangent multiplied by 1.5 where the reverse op
    receives it, so every gradient that flows through K_fu is 1.5 times
    too large.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch
from torch.profiler import record_function

from gpbench import faults, problem, work
from gpbench.reference import sgpr as reference  # noqa: F401  (the model's reference)

KFU_FWD_OP = "_Kfu"
KFU_BWD_OP = "_KfuBackward"
MATMUL_FWD_OP = "_FullPrecisionMatmul"
MATMUL_BWD_OP = "_FullPrecisionMatmulBackward"
# K_fu^T K_fu and K_fu^T Y: two calls of the product op a step
STATS_OPS = {"train": {KFU_FWD_OP: 1, MATMUL_FWD_OP: 2, KFU_BWD_OP: 1, MATMUL_BWD_OP: 2}}
STEP_WORK = {"train": work.sgpr_train_step}
ROOFLINES = {"kfu_fwd": (KFU_FWD_OP, work.kfu_fwd), "kfu_bwd": (KFU_BWD_OP, work.kfu_bwd)}
PARAMS = ("kern", "Z", "log_beta")


def draw(shape, seed: int, device, perturb=None):
    """(params, (X, Y)): `gpbench.problem`'s draw with its latents observed,
    the same bits as the GP-LVM's at these shapes: X is the draw's `q_mu`,
    Y its outputs; the parameters are its kernel's, Z and log_beta."""
    params, Y = problem.draw(shape, seed, device, perturb)
    return {k: params[k] for k in PARAMS}, (params["q_mu"], Y)


class Program:
    """A configured sparse GP regression: its training step. The program is
    imported here, not with this module, so that a run sets the
    configuration's environment first."""

    def __init__(self, config: dict, lr: float, mesh: Optional[str] = None, device="cuda"):
        from repro_torch.core import inference
        from repro_torch.gp.kernels import RBF
        from repro_torch.gp.models import SparseGPRegression
        from repro_torch.optim import AdamConfig, adam_init, adam_update

        if mesh is not None:
            raise ValueError("the benchmark runs SparseGPRegression on one card only")
        if config["kernel"] != "rbf":
            raise ValueError(f"kernel {config['kernel']!r}: the benchmark drives RBF only")
        self.dtype = config["dtype"]
        self.adam = AdamConfig(lr=lr, clip_norm=None, weight_decay=0.0)
        self.mesh = None
        self.local_keys = ()
        self.gp = SparseGPRegression(kernel=RBF(config["Q"]), M=config["M"],
                                     backend=config["backend"], device=device)
        self._value_and_grad = inference.value_and_grad
        self._adam_init, self._adam_update = adam_init, adam_update

    def place(self, params, data):
        return params, data

    def adam_init(self, params):
        return self._adam_init(params, self.adam)

    def train_step(self, params, opt, data):
        """(params, opt, the loss before the update)."""
        with record_function("gpbench.loss_and_grad"):
            value, grads = self._value_and_grad(self.gp._loss, params, data)
        with record_function("gpbench.adam"):
            params, opt, _ = self._adam_update(grads, opt, params, self.adam)
        return params, opt, value


def timed_alone(params, data, dev):
    """K_fu's op's kernels (B7 and B6 at S = 0, as the op launches them) and
    the product op's two calls forward and back (its own `forward` and
    `backward`, on K_fu^T with K_fu and with Y), outside autograd, at these
    inputs (the cotangents 1e-3 throughout): {op: (fn, args, calls)}, or
    None where the program has no such entries.

    The reverse of K_fu^T K_fu is run in autograd's engine after the
    transpose's reverse for K_fu^T Y, and the engine sums K_fu's two
    cotangents that have then arrived (an out-of-place add of two (N, M)
    tensors) inside that node's traced span; the third arrives inside the
    other transpose's. So the reverse is timed with that add."""
    try:
        from repro_torch.core import psi_stats
        from repro_torch.kernels import ops
        fwd, bwd = ops.kfu_cuda, ops.kfu_bwd_cuda
        mm = psi_stats._FullPrecisionMatmul
    except (ImportError, AttributeError):
        return None
    X, Y = data
    Z = params["Z"]
    v = torch.exp(params["kern"]["log_variance"])
    ls = torch.exp(params["kern"]["log_lengthscale"])
    K = fwd(X, Z, v, ls)
    M, D = Z.shape[0], Y.shape[1]

    def cot(*shape):
        return torch.full(shape, 1e-3, device=dev, dtype=Y.dtype)

    g2, gY = cot(M, M), cot(M, D)
    saved = (SimpleNamespace(saved_tensors=(K.T, K), needs_input_grad=(True, True)),
             SimpleNamespace(saved_tensors=(K.T, Y), needs_input_grad=(True, False)))
    sink = SimpleNamespace(save_for_backward=lambda *t: None)

    def products():
        mm.forward(sink, K.T, K)
        mm.forward(sink, K.T, Y)

    def products_bwd():
        gY_K, _ = mm.backward(saved[1], gY)
        _, g2_K = mm.backward(saved[0], g2)
        return gY_K.T + g2_K

    return {KFU_FWD_OP: (fwd, (X, Z, v, ls), 1),
            KFU_BWD_OP: (bwd, (X, Z, v, ls, cot(*K.shape)), 1),
            MATMUL_FWD_OP: (products, (), 2),
            MATMUL_BWD_OP: (products_bwd, (), 2)}


_FWD = ("kfu_cuda", "kfu_plain")
_BWD = ("kfu_bwd_cuda", "kfu_vjp_plain")


def half_batch():
    def fwd(orig):
        def f(X, Z, v, ls, **kw):
            N = X.shape[0]
            h = N - N // 2
            K = orig(X[:h], Z, v, ls, **kw)
            return torch.cat([K, K[:N - h]])
        return f

    def bwd(orig):
        def f(X, Z, v, ls, g, **kw):
            N = X.shape[0]
            h = N - N // 2
            gh = g[:h].clone()
            gh[:N - h] += g[h:]
            dX, dZ, dv, dl = orig(X[:h], Z, v, ls, gh, **kw)
            return torch.cat([dX, torch.zeros_like(X[h:])]), dZ, dv, dl
        return f

    return faults.patched(_FWD, _BWD, fwd, bwd)


def altered(factor: float = 1.5):
    def bwd(orig):
        def f(X, Z, v, ls, g, **kw):
            return orig(X, Z, v, ls, factor * g, **kw)
        return f

    return faults.patched(_FWD, _BWD, None, bwd)


FAULTS = {"half": half_batch, "alter": altered}
