"""The Bayesian GP-LVM with an RBF kernel, as the `repro_torch` facade
(`BayesianGPLVM`) runs it, driven by the benchmark's loop so that a window
ends on time.

  * a training step is `core.inference.fit_adam`'s: `value_and_grad` of
    `core.gplvm.loss` (the facade's `_loss`) through the configured
    statistics backend, then `optim.adam_update`; with a mesh (a cell on
    several cards, one rank a card) the loss is the facade's `_loss` with
    `mesh=distributed.make_gp_mesh()`: `distributed.gplvm_loss_dist` on
    this rank's shard, whose statistics and the globals' cotangents are
    each summed over the ranks in one all-reduce;
  * a state build is `export_state()`'s: `core.gplvm.local_stats` (the
    facade's `_stats`) and `serve.state.build_state`, with nothing cached.

Each call runs under a `record_function` span named after its layer, the
benchmark's own spans around the calls into the program. The data is
`(Y,)`; the reference is `gpbench/reference/gplvm.py`.

Faults planted under the fused statistics op (`FAULTS`):

  * `half_batch`: the op sees only the first half of the points and
    doubles what it sums (the mean taken over the rest); its reverse gives
    the left-out points no gradient;
  * `altered`: one entry of psi2 is wrong where the forward op produces it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.profiler import record_function

from gpbench import faults, problem, work
from gpbench.reference import gplvm as reference  # noqa: F401  (the model's reference)

# the autograd Function of the fused statistics op, and its reverse node:
# what the traced metrics attribute device time to
STATS_FWD_OP = "_SuffStats"
STATS_BWD_OP = "_SuffStatsBackward"
STATS_OPS = {"train": {STATS_FWD_OP: 1, STATS_BWD_OP: 1}, "build": {STATS_FWD_OP: 1}}
STEP_WORK = {"train": work.train_step, "build": work.state_build}
ROOFLINES = {"stats_fwd": (STATS_FWD_OP, work.stats_fwd),
             "stats_bwd": (STATS_BWD_OP, work.stats_bwd)}


def draw(shape, seed: int, device, perturb=None):
    """(params, (Y,)): `gpbench.problem`'s draw."""
    params, Y = problem.draw(shape, seed, device, perturb)
    return params, (Y,)


class Program:
    """A configured Bayesian GP-LVM: its training step and its state build.
    The program is imported here, not with this module, so that a run sets
    the configuration's environment first."""

    def __init__(self, config: dict, lr: float, mesh: Optional[str] = None, device="cuda"):
        """`mesh`: None for one process, or the device type ("cuda", or
        "cpu" for a gloo group) of a mesh over the initialized process
        group, one rank a device. The data's device is the draw's."""
        from repro_torch.core import distributed, gplvm, inference
        from repro_torch.gp.kernels import RBF
        from repro_torch.optim import AdamConfig, adam_init, adam_update
        from repro_torch.serve.state import build_state

        if config["kernel"] != "rbf":
            raise ValueError(f"kernel {config['kernel']!r}: the benchmark drives RBF only")
        self.kernel = RBF(config["Q"])
        self.dtype = config["dtype"]
        self.adam = AdamConfig(lr=lr, clip_norm=None, weight_decay=0.0)
        knobs = dict(kernel=self.kernel, backend=config["backend"])
        self.mesh = None if mesh is None else distributed.make_gp_mesh(device_type=mesh)
        self._distributed = distributed
        self.local_keys = tuple(k for k, role in distributed.PARAM_ROLES.items()
                                if role == "local")
        if self.mesh is None:
            self.loss = functools.partial(gplvm.loss, **knobs)
        else:
            self.loss = distributed.gplvm_loss_dist(self.mesh, **knobs)
        self.stats = functools.partial(gplvm.local_stats, **knobs)
        self._value_and_grad = inference.value_and_grad
        self._adam_init, self._adam_update = adam_init, adam_update
        self._build_state = build_state

    def place(self, params, data):
        """(params, data) as this process holds them: all of it on one card;
        with a mesh this rank's rows of Y and of the local parameters
        (`distributed.shard_gp_params`, `shard`), copied so that the rest
        of the draw can be freed, and the globals as the group's first
        rank holds them."""
        if self.mesh is None:
            return params, data
        params = self._distributed.shard_gp_params(params, self.mesh)
        params = {k: v.clone() if k in self.local_keys else v for k, v in params.items()}
        return params, (self._distributed.shard(data[0], self.mesh).clone(),)

    def adam_init(self, params):
        return self._adam_init(params, self.adam)

    def train_step(self, params, opt, data):
        """(params, opt, the loss before the update)."""
        with record_function("gpbench.loss_and_grad"):
            value, grads = self._value_and_grad(self.loss, params, data)
        with record_function("gpbench.adam"):
            params, opt, _ = self._adam_update(grads, opt, params, self.adam)
        return params, opt, value

    @torch.no_grad()
    def build(self, params, data):
        """The served state (`serve.state.PosteriorState`), on one card."""
        if self.mesh is not None:
            raise ValueError("the benchmark builds the served state on one card only")
        with record_function("gpbench.stats"):
            stats = self.stats(params, *data)
        with record_function("gpbench.build_state"):
            return self._build_state(self.kernel, params, stats)


def timed_alone(params, data, dev):
    """B1 and B2 as the fused op launches them, outside autograd, at these
    inputs (the cotangents 1e-3 throughout): {op: (fn, args, 1)}, or None
    where the program has no such wrappers."""
    try:
        from repro_torch.kernels import ops
        fwd, bwd = ops.suffstats_cuda, ops.suffstats_bwd_cuda
    except (ImportError, AttributeError):
        return None
    Y = data[0]
    M, D = params["Z"].shape[0], Y.shape[1]
    args = (params["q_mu"], torch.exp(params["q_logS"]), Y, params["Z"],
            torch.exp(params["kern"]["log_variance"]),
            torch.exp(params["kern"]["log_lengthscale"]))
    cot = (torch.full((M, M), 1e-3, device=dev, dtype=Y.dtype),
           torch.full((M, D), 1e-3, device=dev, dtype=Y.dtype))
    return {STATS_FWD_OP: (fwd, args, 1), STATS_BWD_OP: (bwd, (*args, *cot), 1)}


_FWD = ("suffstats_cuda", "suffstats_fused_plain")
_BWD = ("suffstats_bwd_cuda", "suffstats_vjp_plain")


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

    return faults.patched(_FWD, _BWD, fwd, bwd)


def altered(factor: float = 1.5):
    def fwd(orig):
        def f(*args, **kw):
            psi2, psiY = orig(*args, **kw)
            psi2 = psi2.clone()
            psi2[0, 0] = psi2[0, 0] * factor
            return psi2, psiY
        return f

    return faults.patched(_FWD, _BWD, fwd, None)


FAULTS = {"half": half_batch, "alter": altered}
