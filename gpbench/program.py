"""The system under test, as a configuration names it: the calls the
`repro_torch` GP-LVM facade (`BayesianGPLVM`) makes, driven by the
benchmark's loop so that a window ends on time.

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
benchmark's own spans around the calls into the program.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.profiler import record_function

# the autograd Function of the fused statistics op, and its reverse node:
# what the traced metrics attribute device time to
STATS_FWD_OP = "_SuffStats"
STATS_BWD_OP = "_SuffStatsBackward"


class GPLVM:
    """A configured Bayesian GP-LVM: its training step and its state build.
    The program is imported here, not with this module, so that a run sets
    the configuration's environment first."""

    def __init__(self, config: dict, lr: float, mesh: Optional[str] = None):
        """`mesh`: None for one process, or the device type ("cuda", or
        "cpu" for a gloo group) of a mesh over the initialized process
        group, one rank a device."""
        from repro_torch.core import distributed, gplvm, inference
        from repro_torch.gp.kernels import RBF
        from repro_torch.optim import AdamConfig, adam_init, adam_update
        from repro_torch.serve.state import build_state

        if config["model"] != "BayesianGPLVM":
            raise ValueError(f"model {config['model']!r}: the benchmark drives BayesianGPLVM only")
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

    def place(self, params, Y):
        """(params, Y) as this process holds them: all of it on one card;
        with a mesh this rank's rows of Y and of the local parameters
        (`distributed.shard_gp_params`, `shard`), copied so that the rest
        of the draw can be freed, and the globals as the group's first
        rank holds them."""
        if self.mesh is None:
            return params, Y
        params = self._distributed.shard_gp_params(params, self.mesh)
        params = {k: v.clone() if k in self.local_keys else v for k, v in params.items()}
        return params, self._distributed.shard(Y, self.mesh).clone()

    def adam_init(self, params):
        return self._adam_init(params, self.adam)

    def train_step(self, params, opt, Y):
        """(params, opt, the loss before the update)."""
        with record_function("gpbench.loss_and_grad"):
            value, grads = self._value_and_grad(self.loss, params, (Y,))
        with record_function("gpbench.adam"):
            params, opt, _ = self._adam_update(grads, opt, params, self.adam)
        return params, opt, value

    @torch.no_grad()
    def build(self, params, Y):
        """The served state (`serve.state.PosteriorState`), on one card."""
        if self.mesh is not None:
            raise ValueError("the benchmark builds the served state on one card only")
        with record_function("gpbench.stats"):
            stats = self.stats(params, Y)
        with record_function("gpbench.build_state"):
            return self._build_state(self.kernel, params, stats)


def kernels_alone():
    """B1 and B2 as the fused op launches them, outside autograd, for timing
    them alone: (forward(mu, S, Y, Z, v, l), backward(..., g2, gY)), or
    None where the program has no such wrappers."""
    try:
        from repro_torch.kernels import ops
        return ops.suffstats_cuda, ops.suffstats_bwd_cuda
    except (ImportError, AttributeError):
        return None
