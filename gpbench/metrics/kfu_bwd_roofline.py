"""K_fu's reverse (B6 at S = 0, `work.kfu_bwd`) least work at the card's
peaks, over the device time of the kernels the K_fu op's reverse node
launched a call (`_KfuBackward`, linked by the trace): the model's
`ROOFLINES["kfu_bwd"]`."""


def read(r):
    return r.roofline("kfu_bwd")
