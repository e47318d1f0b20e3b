"""The system under test, as a configuration names it: the calls the
`repro_torch` GP-LVM facade (`BayesianGPLVM`, no mesh) makes, driven by the
benchmark's loop so that a window ends on time.

  * a training step is `core.inference.fit_adam`'s: `value_and_grad` of
    `core.gplvm.loss` (the facade's `_loss`) through the configured
    statistics backend, then `optim.adam_update`;
  * a state build is `export_state()`'s: `core.gplvm.local_stats` (the
    facade's `_stats`) and `serve.state.build_state`, with nothing cached.

Each call runs under a `record_function` span named after its layer, the
benchmark's own spans around the calls into the program.
"""
from __future__ import annotations

import functools

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

    def __init__(self, config: dict, lr: float):
        from repro_torch.core import gplvm, inference
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
        self.loss = functools.partial(gplvm.loss, **knobs)
        self.stats = functools.partial(gplvm.local_stats, **knobs)
        self._value_and_grad = inference.value_and_grad
        self._adam_init, self._adam_update = adam_init, adam_update
        self._build_state = build_state

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
        """The served state (`serve.state.PosteriorState`)."""
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
