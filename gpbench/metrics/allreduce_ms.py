"""Device milliseconds a step in the collectives' kernels (NCCL's, found by
name) on the traced rank. A collective's kernel runs from its launch until
the slowest rank's share has arrived, so the time counts the waits for the
other ranks as well as the transfer. None where the trace holds no such
kernel, as on one card."""


def read(r):
    s = sum(v for name, v in r.traced.kernel_s.items() if "nccl" in name.lower())
    return 1e3 * s / r.done if s > 0 else None
