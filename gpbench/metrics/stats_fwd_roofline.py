"""B1's least work (the fused forward statistics) at the card's peaks, over
the device time of the kernels the statistics op's forward launched a
call (`_SuffStats`, linked by the trace)."""
from gpbench import program, work


def read(r):
    t = r.op_seconds(program.STATS_FWD_OP)
    if t is None:
        return None
    return 100 * work.bound_s(work.stats_fwd(*r.shapes()), r.shape["dtype"]) / t
