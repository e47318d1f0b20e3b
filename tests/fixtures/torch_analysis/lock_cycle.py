"""Seeded concurrency violation (ANL005): an AB/BA lock-order cycle.
`transfer_in` takes ledger -> journal, `transfer_out` takes journal ->
ledger — two threads interleaving these deadlock. Analyzed as source text
with a virtual repro_torch/ path; never imported."""
import threading

_LEDGER_LOCK = threading.Lock()
_JOURNAL_LOCK = threading.Lock()


def transfer_in() -> None:
    with _LEDGER_LOCK:
        with _JOURNAL_LOCK:  # ANL005: edge ledger -> journal
            pass


def transfer_out() -> None:
    with _JOURNAL_LOCK:
        with _LEDGER_LOCK:  # ANL005: reverse edge closes the cycle
            pass
