"""Seeded concurrency violation (ANL007): blocking work under a lock.
`snapshot` holds `_STATE_LOCK` across file I/O, a device synchronization
and a Future wait — every thread behind the lock stalls on the disk, the
card and the executor. Analyzed as source text with a virtual repro_torch/
path; never imported."""
import json
import threading

import torch

_STATE_LOCK = threading.Lock()
_STATE = {"n": 0}


def snapshot(path, future) -> None:
    with _STATE_LOCK:
        with open(path, "w") as f:  # ANL007: file I/O under the lock
            json.dump(_STATE, f)  # ANL007: and the dump itself
        torch.cuda.synchronize()  # ANL007: a device wait under the lock
        future.result()  # ANL007: Future wait under the lock
