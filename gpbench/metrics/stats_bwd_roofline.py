"""B2's least work (the fused reverse pass) at the card's peaks, over the
device time of the kernels the statistics op's reverse node launched a
call (`_SuffStatsBackward`, linked by the trace): the model's
`ROOFLINES["stats_bwd"]`."""


def read(r):
    return r.roofline("stats_bwd")
