"""B2's least work (the fused reverse pass) at the card's peaks, over the
device time of the kernels the statistics op's reverse node launched a
call (`_SuffStatsBackward`, linked by the trace)."""
from gpbench import program, work


def read(r):
    t = r.op_seconds(program.STATS_BWD_OP)
    if t is None:
        return None
    return 100 * work.bound_s(work.stats_bwd(*r.shapes()), r.shape["dtype"]) / t
