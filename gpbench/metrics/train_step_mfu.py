"""The whole training step's least work (the model's `STEP_WORK["train"]`)
at the card's published peaks, over the untraced step time."""


def read(r):
    return r.step_mfu("train")
