"""A training step's work counted from its parts (the port's counterpart of
`repro.launch.hlo_cost`, which parses the compiled HLO; eager PyTorch has
no HLO to parse).

A GP-LVM step is, per rank:

  * its statistics passes: each kernel launch (or plain version on the
    CPU) the ops note inside `kernels.ops.recording()`, counted by the
    kernel's least work at that pass's (N, M, Q, D, dtype)
    (`launch.roofline.KERNEL_WORK`);
  * the O(M^3) epilogue: two Cholesky factors, two M x M triangular
    solves and the bound's O(M^2 (Q + D)) terms, forward and reverse
    (reverse ~2x forward): ~8 M^3 flops, 2 M^2 exps (K_uu and the psi2
    prefactor), ~24 M x M matrices moved;
  * the per-point work outside the kernels (S = exp(q_logS), the KL and
    their cotangents, y . y);
  * Adam over every parameter element: p, g, m and v read, p, m and v
    written, g read again for the global norm; ~14 flops an element;
  * with W > 1 ranks, one ring all-reduce of the statistics forward
    (psi0, psi2, psiY, yy, n and the GP-LVM's KL) and one of the global
    parameters' cotangents in reverse (`core.distributed`).

The counts are least work, like the kernels' bounds: a plain version or
an eager epilogue moves more. `StepCost` names its parts, so a reader sees
what binds; `terms` gives the roofline terms of the whole step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import torch

from repro_torch.launch import roofline
from repro_torch.launch.roofline import Work

__all__ = ["Part", "StepCost", "kernel_parts", "epilogue_part", "pointwise_part",
           "adam_part", "allreduce_part", "gplvm_param_count", "gplvm_step_cost"]


def _itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


@dataclasses.dataclass(frozen=True)
class Part:
    """One part of a step: its name, least work, and the collective bytes
    a rank sends."""
    name: str
    work: Work
    collective_bytes: float = 0.0


@dataclasses.dataclass(frozen=True)
class StepCost:
    """A step's parts and their totals, per rank."""
    parts: Tuple[Part, ...]
    dtype: torch.dtype

    @property
    def flops(self) -> float:
        return sum(p.work.flops for p in self.parts)

    @property
    def exps(self) -> float:
        return sum(p.work.exps for p in self.parts)

    @property
    def nbytes(self) -> float:
        return sum(p.work.nbytes for p in self.parts)

    @property
    def collective_bytes(self) -> float:
        return sum(p.collective_bytes for p in self.parts)

    def terms(self) -> Dict:
        """The step's roofline terms (`launch.roofline.roofline_terms`)."""
        return roofline.roofline_terms(self.flops, self.exps, self.nbytes,
                                       self.collective_bytes, self.dtype)

    def table(self) -> List[Dict]:
        """One JSON-ready row per part, with its own bound in ms."""
        return [{"part": p.name, "flops": p.work.flops, "exps": p.work.exps,
                 "bytes": p.work.nbytes, "collective_bytes": p.collective_bytes,
                 "bound_ms": roofline.bound(p.work, self.dtype)[0]}
                for p in self.parts]


def kernel_parts(passes: Iterable) -> List[Part]:
    """One part per statistics pass (`kernels.ops.StatsPass`), by its
    kernel's least work at its shapes and dtype."""
    return [Part(f"{p.lib} N={p.N} M={p.M} Q={p.Q}" + (f" D={p.D}" if p.D else ""),
                 roofline.KERNEL_WORK[p.lib](p.N, p.M, p.Q, p.D, p.dtype))
            for p in passes]


def epilogue_part(M: int, Q: int, D: int, dtype: torch.dtype) -> Part:
    """The O(M^3) epilogue, forward and reverse (module docstring)."""
    flops = 8 * M**3 + 6 * M * M * (3 * Q + 2 + D)
    return Part("epilogue", Work(flops, 2 * M * M,
                                 _itemsize(dtype) * (24 * M * M + 4 * M * D)))


def pointwise_part(N: int, Q: int, D: int, dtype: torch.dtype) -> Part:
    """The GP-LVM's per-point work outside the kernels: y . y (2D flops a
    point, Y read), S = exp(q_logS), the KL (5 flops an element) and the
    two cotangents dq_logS = dS S + (S - 1) / 2 and dq_mu = dmu + mu (6
    flops), ~11 elements moved per (point, q)."""
    return Part("pointwise", Work(11 * N * Q + 2 * N * D, N * Q,
                                  _itemsize(dtype) * (11 * N * Q + N * D)))


def adam_part(n_elements: int, dtype: torch.dtype) -> Part:
    """Adam over `n_elements` parameter elements (moments in the
    parameters' dtype): 8 elements moved and ~14 flops each."""
    return Part("adam", Work(14 * n_elements, 0, 8 * _itemsize(dtype) * n_elements))


def allreduce_part(M: int, Q: int, D: int, world: int, dtype: torch.dtype) -> Part:
    """The GP-LVM's statistics all-reduce forward and the global
    cotangents' all-reduce in reverse, as ring traffic a rank sends; no
    work."""
    size = _itemsize(dtype)
    stats = size * (M * M + M * D + 5)  # psi0, psi2, psiY, yy, n and the KL
    grads = size * (M * Q + Q + 2)  # Z, kern (variance, lengthscales), log_beta
    traffic = (roofline.ring_allreduce_bytes(stats, world)
               + roofline.ring_allreduce_bytes(grads, world))
    return Part(f"all-reduce W={world}", Work(0, 0, 0), traffic)


def gplvm_param_count(N: int, M: int, Q: int) -> int:
    """Parameter elements of a GP-LVM shard of N points: q_mu, q_logS, Z,
    the kernel's variance and Q lengthscales, log_beta."""
    return 2 * N * Q + M * Q + Q + 2


def gplvm_step_cost(passes: Iterable, *, N: int, M: int, Q: int, D: int,
                    dtype: torch.dtype, world: int = 1) -> StepCost:
    """One GP-LVM Adam step of a rank holding N points: its statistics
    passes (the step's `kernels.ops.recording()` log), the epilogue, the
    per-point work, Adam and, with W > 1, the two all-reduces."""
    parts = kernel_parts(passes) + [
        epilogue_part(M, Q, D, dtype),
        pointwise_part(N, Q, D, dtype),
        adam_part(gplvm_param_count(N, M, Q), dtype),
    ]
    if world > 1:
        parts.append(allreduce_part(M, Q, D, world, dtype))
    return StepCost(tuple(parts), dtype)
