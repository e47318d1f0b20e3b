"""The untraced step time less the traced device time a step of the
model's statistics ops (`STATS_OPS["train"]` of `gpbench/models/<model>.py`:
the GP-LVM's fused op forward and reverse; the regression's K_fu op and
its two products, each forward and reverse): the epilogue, Adam, the
per-point terms and the host's share."""


def read(r):
    t = r.per_item_s()
    for op, calls in r.model.STATS_OPS["train"].items():
        s = r.op_seconds(op)
        if s is None:
            return None
        t -= s * calls
    return 1e3 * t
