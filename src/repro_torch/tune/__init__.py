"""repro_torch.tune: empirical launch-geometry and chunk autotuner with a
persistent cache (counterpart of `repro.tune`).

The wave count of every kernel wrapper's N-splits and the streaming chunk
become MEASURED decisions: on first use of a kernel at a key the tuner
times every admissible wave count on the card and persists the winner
(`~/.cache/repro_torch/tune.json`, override with $REPRO_TORCH_TUNE_CACHE);
every later process is a pure lookup with zero timing runs. `kernels.ops`
consults `best_blocks()` for all seven kernels on the card, and
`chunk="auto"` anywhere a chunk is accepted resolves through
`best_chunk()`.

Measurement is on by default only on a CUDA device; REPRO_TORCH_TUNE=0
turns it off there and REPRO_TORCH_TUNE=1 forces it elsewhere, and
$REPRO_TORCH_TUNE_MAX_CANDIDATES caps the candidates timed a key.
"""
from repro_torch.tune.autotune import (
    TUNE_ENV,
    best_blocks,
    best_chunk,
    clear_memo,
    enabled,
    make_key,
    measure_blocks,
    measure_chunks,
    timing_runs,
)
from repro_torch.tune.cache import (
    CACHE_ENV,
    SCHEMA_VERSION,
    cache_path,
    load_entries,
    lookup,
    store,
)
from repro_torch.tune.search import (
    CHUNK_CANDIDATES,
    DEFAULT_CHUNK,
    DEFAULT_WAVES,
    MEASURE_N,
    MEASURE_PROBLEM,
    WAVE_CANDIDATES,
    Problem,
    admissible,
    candidate_blocks,
    candidate_chunks,
    default_blocks,
)

__all__ = [
    "CACHE_ENV",
    "CHUNK_CANDIDATES",
    "DEFAULT_CHUNK",
    "DEFAULT_WAVES",
    "MEASURE_N",
    "MEASURE_PROBLEM",
    "Problem",
    "SCHEMA_VERSION",
    "TUNE_ENV",
    "WAVE_CANDIDATES",
    "admissible",
    "best_blocks",
    "best_chunk",
    "cache_path",
    "candidate_blocks",
    "candidate_chunks",
    "clear_memo",
    "default_blocks",
    "enabled",
    "load_entries",
    "lookup",
    "make_key",
    "measure_blocks",
    "measure_chunks",
    "store",
    "timing_runs",
]
