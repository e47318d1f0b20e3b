"""`repro_torch.temporal` — the state-space GP backend (counterpart of
`repro.temporal`): kernel -> LTI SDE -> parallel associative-scan Kalman
filter/smoother (log depth) with a sequential twin, for 1-D stationary
kernels (Matern12/32/52 and Sum/Product of them). Selected through
`repro_torch.gp.regression(backend="temporal")` and served through
`repro_torch.serve` via `TemporalState`.
"""
from repro_torch.temporal.model import (TemporalGPRegression, TemporalState,
                                        forecast, forecast_closure,
                                        update_state)
from repro_torch.temporal.pskf import FilterResult, kalman_filter, rts_smoother
from repro_torch.temporal.sde import LTISDE, discretize

__all__ = [
    "LTISDE",
    "discretize",
    "FilterResult",
    "kalman_filter",
    "rts_smoother",
    "TemporalGPRegression",
    "TemporalState",
    "forecast",
    "forecast_closure",
    "update_state",
]
