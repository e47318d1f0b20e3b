"""Seeded concurrency violation (ANL006): a lock-guarded attribute touched
without the lock. `put` establishes that `self._table` is shared state
guarded by `self._lock`; `drop` then mutates it lock-free — the race
class guard inference exists to catch (the generalized ANL002). Analyzed
as source text with a virtual repro_torch/ path; never imported."""
import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._table = {}

    def put(self, key, value) -> None:
        with self._lock:
            self._table[key] = value

    def drop(self, key) -> None:
        self._table.pop(key, None)  # ANL006: lock-free write races put()
