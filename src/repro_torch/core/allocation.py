"""Time-varying memory allocation plans.

Every prediction method in this framework (KS+ and all baselines) emits an
:class:`AllocationPlan` — a monotone-indexable step function
``alloc(t) = peaks[max { i < n : starts[i] <= t }]`` with the last peak held
until the job completes.  The cluster simulator and the wastage metric are
therefore method-agnostic.

The arithmetic itself lives in :mod:`repro_torch.core.envelope` in packed
``(B, K)`` form; the helpers here are the 1-lane views, kept for per-plan
callers (oracles, examples, small scripts).

Times are seconds, memory is GB throughout ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.envelope import alloc_at_packed, first_violation_packed

__all__ = ["AllocationPlan", "alloc_at", "alloc_series", "first_violation"]


@dataclasses.dataclass(frozen=True)
class AllocationPlan:
    """A step-function memory allocation.

    Attributes:
      starts: (n,) ascending start offsets in seconds; ``starts[0] == 0``.
      peaks:  (n,) allocation in GB active from ``starts[i]`` until the next
              start (or job end for the last segment).
    """

    starts: np.ndarray
    peaks: np.ndarray

    def __post_init__(self):
        starts = np.asarray(self.starts, dtype=np.float64)
        peaks = np.asarray(self.peaks, dtype=np.float64)
        if starts.ndim != 1 or peaks.shape != starts.shape or starts.size == 0:
            raise ValueError("starts/peaks must be equal-length 1-D arrays")
        object.__setattr__(self, "starts", starts)
        object.__setattr__(self, "peaks", peaks)

    @property
    def n(self) -> int:
        return int(self.starts.size)

    def is_monotone(self) -> bool:
        return bool(np.all(np.diff(self.peaks) >= -1e-12))

    def segment_at(self, t: float) -> int:
        """Index of the segment active at time ``t``."""
        return max(int(np.searchsorted(self.starts, t, side="right")) - 1, 0)

    def with_(self, *, starts: Optional[np.ndarray] = None,
              peaks: Optional[np.ndarray] = None) -> "AllocationPlan":
        return AllocationPlan(
            starts=self.starts if starts is None else starts,
            peaks=self.peaks if peaks is None else peaks,
        )


def alloc_at(plan: AllocationPlan, t: np.ndarray | float) -> np.ndarray:
    """Evaluate the plan at time(s) ``t`` — 1-lane view of
    :func:`repro_torch.core.envelope.alloc_at_packed`."""
    t_arr = np.asarray(t, dtype=np.float64)
    out = alloc_at_packed(plan.starts[None, :], plan.peaks[None, :],
                          t_arr.reshape(1, -1))
    return out.reshape(t_arr.shape)


def alloc_series(plan: AllocationPlan, num_samples: int, dt: float) -> np.ndarray:
    """Allocation evaluated on the sampling grid ``t_i = i * dt``."""
    t = np.arange(num_samples, dtype=np.float64) * dt
    return alloc_at(plan, t)


def first_violation(plan: AllocationPlan, mem: np.ndarray, dt: float) -> int:
    """First sample index where usage exceeds the allocation, or -1.

    This is the simulator's OOM-killer: the job is terminated during the
    first sample whose memory demand is above the active limit.  1-lane view
    of :func:`repro_torch.core.envelope.first_violation_packed`.
    """
    mem = np.asarray(mem, dtype=np.float64)
    return int(first_violation_packed(
        plan.starts[None, :], plan.peaks[None, :], mem[None, :],
        np.asarray([len(mem)]), dt)[0])
