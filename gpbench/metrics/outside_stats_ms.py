"""The untraced step time less the traced device time of the statistics
op's forward and reverse kernels a step: the epilogue, Adam, the per-point
terms and the host's share."""
from gpbench import program


def read(r):
    fwd, bwd = r.op_seconds(program.STATS_FWD_OP), r.op_seconds(program.STATS_BWD_OP)
    if fwd is None or bwd is None:
        return None
    return 1e3 * (r.per_item_s() - fwd - bwd)
