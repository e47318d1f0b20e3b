"""The whole training step's least work at the card's published peaks,
over the untraced step time."""
from gpbench import work


def read(r):
    return 100 * work.bound_s(work.train_step(*r.shapes()), r.shape["dtype"]) / r.per_item_s()
