"""Fault-tolerant training loop (counterpart of `repro.runtime.train_loop`).

  * resume: on start, restore the latest checkpoint (params, optimizer
    state, data-iterator state, step counter) if one exists;
  * periodic + final checkpoints, async saves overlapping the next step
    (the manager copies every leaf to the host before it returns);
  * transient-failure retry: a step that raises is retried after
    re-syncing from the last checkpoint;
  * straggler watchdog: per-step wall times feed a running median; a step
    slower than `straggler_factor` x median is logged;
  * preemption hook: SIGTERM triggers a final checkpoint before exit.

Checkpoints are the port's `checkpoint.manager` layout, whose keys and
files are the reference's: {"params", "opt"} with extra {"step", "data"},
so a loop of either package resumes the other's. `shardings=(param
shardings, opt shardings)` (a step bundle's `in_shardings[:2]`) places
the restored leaves on the current mesh, which need not be the mesh that
saved them; without it every leaf is restored onto the device of the
loop's parameters.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import statistics
import tempfile
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.optim.adam import flatten

Tree = Any


@dataclasses.dataclass
class LoopConfig:
    # Under the caller's temp dir (TMPDIR), not a fixed path shared by every checkout.
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep: int = 3
    max_retries: int = 2
    straggler_factor: float = 3.0
    log_every: int = 10
    async_save: bool = True


class TrainLoop:
    def __init__(self, step_fn: Callable, params: Tree, opt_state: Tree, data_iter,
                 loop_cfg: LoopConfig, *, shardings: Optional[tuple] = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data_iter
        self.cfg = loop_cfg
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, keep=loop_cfg.keep)
        self.device = flatten(params)[1][0].device
        self.shardings = shardings  # (param_shardings, opt_shardings) or None
        self.step = 0
        self.step_times: list[float] = []
        self._preempted = False
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not on the main thread (tests)

    def _on_sigterm(self, *_):
        self._preempted = True

    # ------------------------------------------------------------------
    def try_resume(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        shardings = None
        if self.shardings is not None:
            shardings = {"params": self.shardings[0], "opt": self.shardings[1]}
        restored, extra = self.ckpt.restore({"params": self.params, "opt": self.opt_state},
                                            device=self.device, shardings=shardings)
        self.params, self.opt_state = restored["params"], restored["opt"]
        self.step = int(extra["step"])
        if hasattr(self.data, "restore_state") and "data" in extra:
            self.data.restore_state(extra["data"])
        print(f"[resume] restored step {self.step} from {self.cfg.ckpt_dir}")
        return True

    def _save(self, blocking: bool) -> None:
        extra = {"step": self.step}
        if hasattr(self.data, "checkpoint_state"):
            extra["data"] = self.data.checkpoint_state()
        self.ckpt.save(self.step, {"params": self.params, "opt": self.opt_state},
                       extra=extra, blocking=blocking)

    def _sync(self, loss: torch.Tensor) -> None:
        """Wait for the step's work (the reference's block_until_ready)."""
        if loss.is_cuda:
            torch.cuda.synchronize(loss.device)

    # ------------------------------------------------------------------
    def run(self, num_steps: int) -> Dict[str, float]:
        self.try_resume()
        metrics: Dict[str, float] = {}
        while self.step < num_steps and not self._preempted:
            batch = self.data.next()
            t0 = time.perf_counter()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    self.params, self.opt_state, m = self.step_fn(
                        self.params, self.opt_state, batch)
                    self._sync(m["loss"])
                    break
                except Exception as e:  # noqa: BLE001 — transient-failure path
                    if attempt == self.cfg.max_retries:
                        self._save(blocking=True)
                        raise
                    print(f"[retry] step {self.step} failed ({type(e).__name__}: {e}); "
                          f"re-syncing from checkpoint (attempt {attempt + 1})")
                    if self.ckpt.latest_step() is not None:
                        self.try_resume()
            dt = time.perf_counter() - t0
            self._watch_stragglers(dt)
            self.step += 1
            metrics = {k: float(v) for k, v in m.items()}
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                print(f"step {self.step:6d} loss {metrics['loss']:.4f} "
                      f"gnorm {metrics.get('grad_norm', float('nan')):.3f} {dt*1e3:.0f} ms")
            if self.cfg.ckpt_every and self.step % self.cfg.ckpt_every == 0:
                self._save(blocking=not self.cfg.async_save)
        self.ckpt.wait()
        self._save(blocking=True)
        return metrics

    def _watch_stragglers(self, dt: float) -> None:
        self.step_times.append(dt)
        window = self.step_times[-50:]
        if len(window) >= 10:
            med = statistics.median(window[:-1])
            if dt > self.cfg.straggler_factor * med:
                print(f"[straggler] step {self.step} took {dt*1e3:.0f} ms "
                      f"(median {med*1e3:.0f} ms) — flagging host for reschedule; "
                      "sync SPMD makes the slowest device the step time")
