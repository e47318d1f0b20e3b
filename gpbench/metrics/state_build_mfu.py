"""A state build's least work (the model's `STEP_WORK["build"]`: for the
GP-LVM the forward statistics, the refold and the per-point terms) at the
card's published peaks, over the untraced build time."""


def read(r):
    return r.step_mfu("build")
