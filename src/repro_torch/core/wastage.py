"""Memory-wastage metric (GB·s) and the OOM/retry simulation loop.

Wastage of one task execution (paper §III-A): the integral of
``allocated − used`` over the successful attempt **plus** the integral of
``allocated`` over every failed attempt.  Failures happen at the first
sample whose demand exceeds the active allocation (the simulated OOM
killer), after which the method's retry strategy produces a new plan and the
execution restarts from t = 0.

The inner evaluation — step-function allocation vs. trace, summed — is the
fleet-scale hot loop (methods × seeds × executions × samples); a CUDA
kernel implementing the batched version lives in
``repro_torch.kernels.wastage`` with :func:`wastage_eval_ref` as its oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np

from repro_torch.core.allocation import AllocationPlan, alloc_series, first_violation

__all__ = [
    "AttemptRecord",
    "ExecutionResult",
    "simulate_execution",
    "oom_probe_ref",
]

RetryFn = Callable[[AllocationPlan, float, float], AllocationPlan]


@dataclasses.dataclass(frozen=True)
class AttemptRecord:
    plan: AllocationPlan
    failed_at: float  # seconds; -1 for the successful attempt
    wastage_gbs: float


@dataclasses.dataclass(frozen=True)
class ExecutionResult:
    attempts: List[AttemptRecord]
    wastage_gbs: float
    succeeded: bool

    @property
    def num_retries(self) -> int:
        return len(self.attempts) - 1


def simulate_execution(
    plan: AllocationPlan,
    retry: RetryFn,
    mem: np.ndarray,
    dt: float,
    *,
    max_attempts: int = 25,
    machine_memory: float = np.inf,
) -> ExecutionResult:
    """Run one task execution against a plan + retry strategy.

    ``machine_memory`` caps every allocation (a node cannot grant more than
    it has); a demand above the cap makes the execution unsatisfiable and is
    reported as ``succeeded=False`` with the accumulated wastage.
    """
    mem = np.asarray(mem, dtype=np.float64)
    attempts: List[AttemptRecord] = []
    total = 0.0
    for _ in range(max_attempts):
        capped = plan.with_(peaks=np.minimum(plan.peaks, machine_memory))
        v = first_violation(capped, mem, dt)
        alloc = alloc_series(capped, len(mem), dt)
        if v < 0:
            w = float(np.sum(alloc - mem) * dt)
            attempts.append(AttemptRecord(capped, -1.0, w))
            return ExecutionResult(attempts, total + w, True)
        # Failed attempt: everything allocated until the kill is wasted.
        w = float(np.sum(alloc[: v + 1]) * dt)
        total += w
        t_fail = v * dt
        attempts.append(AttemptRecord(capped, t_fail, w))
        if np.max(mem) > machine_memory:
            break  # no allocation can satisfy this job on this node class
        plan = retry(capped, t_fail, float(mem[v]))
    return ExecutionResult(attempts, total, False)


def wastage_eval_ref(
    starts: np.ndarray,
    peaks: np.ndarray,
    mems: np.ndarray,
    lengths: np.ndarray,
    dt: float,
) -> np.ndarray:
    """Batched successful-attempt wastage: oracle for the CUDA kernel.

    Args:
      starts: (B, k) plan start offsets (seconds).
      peaks:  (B, k) plan peaks (GB).
      mems:   (B, T) padded traces (GB).
      lengths: (B,) valid sample counts.
      dt:     sampling period.

    Returns:
      (B,) wastage in GB·s assuming each attempt succeeds (allocation
      clamped from below by the trace, mirroring the kernel contract).
    """
    B, T = mems.shape
    t = np.arange(T, dtype=np.float64)[None, :] * dt
    # alloc[b, t] = peaks[b, max i: starts[b, i] <= t]
    active = (starts[:, None, :] <= t[:, :, None]).astype(np.float64)
    idx = np.maximum(active.cumsum(axis=2).argmax(axis=2), 0)
    alloc = np.take_along_axis(peaks, idx.reshape(B, -1), axis=1).reshape(B, T)
    alloc = np.maximum(alloc, mems)  # successful attempt ⇒ alloc >= used
    valid = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float64)
    return ((alloc - mems) * valid).sum(axis=1) * dt


def oom_probe_ref(
    starts: np.ndarray,
    peaks: np.ndarray,
    mems: np.ndarray,
    lengths: np.ndarray,
    dt: float,
):
    """Batched one-attempt OOM probe: oracle for the CUDA probe kernel.

    For every lane evaluates the plan against the trace once and returns

      viol:   (B,) int32  — first sample index with ``mem > alloc``, or -1,
      w_succ: (B,) float  — wastage assuming the attempt succeeds
                            (``max(alloc, mem) − mem`` integrated),
      w_kill: (B,) float  — wastage if the attempt is killed at ``viol``
                            (all allocation up to and including the kill
                            sample), 0 where ``viol < 0``.
    """
    B, T = mems.shape
    mems = np.asarray(mems, np.float64)
    t = np.arange(T, dtype=np.float64) * dt
    idx = np.stack([
        np.clip(np.searchsorted(s, t, side="right") - 1, 0, len(s) - 1)
        for s in np.asarray(starts, np.float64)
    ])
    alloc = np.take_along_axis(np.asarray(peaks, np.float64), idx, axis=1)
    valid = np.arange(T)[None, :] < lengths[:, None]
    bad = (mems > alloc) & valid
    any_v = bad.any(axis=1)
    vidx = bad.argmax(axis=1)
    viol = np.where(any_v, vidx, -1).astype(np.int32)
    w_succ = ((np.maximum(alloc, mems) - mems) * valid).sum(axis=1) * dt
    prefix = np.cumsum(alloc * valid, axis=1)
    w_kill = np.where(
        any_v, np.take_along_axis(prefix, vidx[:, None], axis=1)[:, 0], 0.0
    ) * dt
    return viol, w_succ, w_kill
