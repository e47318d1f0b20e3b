"""Seeded kernel-audit violations: a K_fu-style launch plan whose block
keeps its run's whole (run, M) output tile in shared memory instead of
streaming it out, and whose N-splits are N // P points each, dropping the
remainder of N. The audit must report SMEM001 under a shared-memory budget
smaller than the tile (and nothing under the real budget at M = 256 in
float32, where 135 KB still fits), and COVER001 where P does not divide
N."""
import torch

from repro_torch.analysis.kernel_audit import Pass, Plan

RUN, THREADS, SPLITS = 128, 256, 132


def bloated_plan(problem, dtype):
    itemsize = torch.finfo(dtype).bits // 8
    N, M, Q = problem.N, problem.M, problem.Q
    P = max(1, min(SPLITS, N // RUN))
    size = N // P
    splits = tuple((p * size, (p + 1) * size) for p in range(P))  # drops N % P
    smem = itemsize * (RUN * M + M * Q)  # the whole output tile stays resident
    return Plan(passes=(Pass("cross", (P, 1), THREADS),), splits=(P,),
                scratch_bytes=0, smem_bytes=smem,
                covers=(("N-splits", splits, N), ("columns", ((0, M),), M)))
