"""A state build's least work (the forward statistics, the refold and the
per-point terms) at the card's published peaks, over the untraced build
time."""
from gpbench import work


def read(r):
    return 100 * work.bound_s(work.state_build(*r.shapes()), r.shape["dtype"]) / r.per_item_s()
