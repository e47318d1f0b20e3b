"""B1's least work (the fused forward statistics) at the card's peaks, over
the device time of the kernels the statistics op's forward launched a
call (`_SuffStats`, linked by the trace): the model's `ROOFLINES["stats_fwd"]`."""


def read(r):
    return r.roofline("stats_fwd")
