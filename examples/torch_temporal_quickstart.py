"""Temporal quickstart for the PyTorch/CUDA port: streaming forecasts from
a state-space GP.

    PYTHONPATH=src python examples/torch_temporal_quickstart.py [--n 100000]
    PYTHONPATH=src python examples/torch_temporal_quickstart.py --device cpu --n 4000 --steps 30

Fits `TemporalGPRegression` (backend="temporal") on the left half of a
long, non-uniformly sampled series — the parallel-scan Kalman path, no
(N, N) matrix anywhere — registers its O(d^2) `TemporalState` with a
`GPServer`, then streams the right half in 20 chunks through
`server.update()` (the sequential filter), forecasting a short window past
the frontier before each chunk. Asserts the JAX example's criteria. The
series comes from a numpy generator, so the draw is not the JAX
example's.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.gp import get, regression
from repro_torch.serve import GPServer


def series(n: int, seed: int = 0):
    """Timestamps (n, 1) with gaps uniform in [0.5e-3, 1.5e-3], the latent
    f = sin(2 pi 0.8 t) and Y = f + N(0, 0.1^2) noise (n, 1), float64."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.uniform(0.5e-3, 1.5e-3, n))[:, None]
    f = np.sin(2.0 * np.pi * 0.8 * t[:, 0])
    return t, f, (f + 0.1 * rng.standard_normal(n))[:, None]


def rmse(mean, truth) -> float:
    return float(np.sqrt(np.mean((mean.cpu().numpy()[:, 0] - truth) ** 2)))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    n = args.n
    t, f, Y = series(n)
    half = n // 2

    # --- fit on the left half only; the right half arrives "in production"
    gp = regression(get("matern32")(1), backend="temporal", device=args.device)
    gp.fit(t[:half], Y[:half], steps=args.steps, lr=5e-2)
    print(f"fitted temporal GP on {half} points (lml/N={gp.lml() / half:.3f})")

    server = GPServer(device=args.device)
    server.register("sensor", gp)  # export_state(): terminal (m, P), O(d^2)
    state = server.state("sensor")
    print(f"registered TemporalState: d={state.d}, {state.nbytes} bytes, "
          f"n={int(state.n)} points absorbed")

    # --- stream the right half in chunks: forecast a short window past the
    # current frontier, then filter the whole chunk forward
    chunk = max(64, (n - half) // 20)
    horizon = 64
    errors = []
    for start in range(half, n, chunk):
        sl = slice(start, min(start + chunk, n))
        h = slice(start, min(start + horizon, n))
        mean, _ = server.predict("sensor", t[h])  # forecast before seeing
        errors.append(rmse(mean, f[h]))
        server.update("sensor", t[sl], Y[sl])  # filter forward
    print(f"streamed {n - half} points in {len(errors)} chunks; "
          f"{horizon}-point-ahead forecast RMSE first={errors[0]:.3f} "
          f"median={sorted(errors)[len(errors) // 2]:.3f} last={errors[-1]:.3f}")

    # every forecast is made at the filter frontier, so the error sits near
    # the noise floor (0.1) throughout
    assert max(errors) < 0.35, errors
    assert sorted(errors)[len(errors) // 2] < 0.2, errors
    n_final = int(server.state("sensor").n)
    assert n_final == n, (n_final, n)
    server.close()
    print("temporal quickstart OK")
    return errors


if __name__ == "__main__":
    main()
