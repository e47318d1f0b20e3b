"""B7's least work (K_fu, `work.kfu_fwd`, as `launch/roofline.py`'s
`kfu_work` counts it) at the card's peaks, over the device time of the
kernels the K_fu op's forward launched a call (`_Kfu`, linked by the
trace): the model's `ROOFLINES["kfu_fwd"]`."""


def read(r):
    return r.roofline("kfu_fwd")
