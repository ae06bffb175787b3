"""Failure-handling strategies (KS+ §II-C and baseline strategies).

All strategies are pure functions ``(plan, t_fail, used_at_fail) -> plan`` so
the cluster simulator can drive any method through the same OOM/retry loop.

KS+ retry: memory peaks are usually right, the *timing* is wrong — so on OOM
before the last segment, re-time: scale every succeeding segment start so the
next one begins exactly at the failure time.  Only when the failure is
already inside the last segment is its peak raised (+20 %).

Each function here is the 1-lane view of the packed, vectorized rule in
:func:`repro_torch.core.envelope.retry_packed` — there is exactly one float64
implementation of every rule.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.envelope import RetrySpec, retry_packed

__all__ = [
    "ksplus_retry",
    "ksegments_selective_retry",
    "ksegments_partial_retry",
    "double_retry",
    "max_machine_retry",
    "apply_retry_spec",
]


def apply_retry_spec(spec: RetrySpec, plan: AllocationPlan, t_fail: float,
                     used: float,
                     machine_memory: float = np.inf) -> AllocationPlan:
    """Apply a static :class:`RetrySpec` to one plan (1-lane packed view)."""
    starts, peaks = retry_packed(
        spec, plan.starts[None, :], plan.peaks[None, :],
        np.asarray([plan.n]), np.asarray([t_fail]), np.asarray([used]),
        machine_memory=machine_memory)
    return plan.with_(starts=starts[0], peaks=peaks[0])


def ksplus_retry(plan: AllocationPlan, t_fail: float, used: float,
                 *, last_peak_bump: float = 0.20) -> AllocationPlan:
    """KS+ §II-C: re-time succeeding segments, or bump the last peak."""
    return apply_retry_spec(RetrySpec("ksplus", bump=last_peak_bump),
                            plan, t_fail, used)


def ksegments_selective_retry(plan: AllocationPlan, t_fail: float, used: float,
                              *, margin: float = 0.10) -> AllocationPlan:
    """k-Segments 'Selective': raise only the failed segment's peak."""
    return apply_retry_spec(RetrySpec("kseg-selective", margin=margin),
                            plan, t_fail, used)


def ksegments_partial_retry(plan: AllocationPlan, t_fail: float, used: float,
                            *, margin: float = 0.10) -> AllocationPlan:
    """k-Segments 'Partial': raise the failed segment and every later one."""
    return apply_retry_spec(RetrySpec("kseg-partial", margin=margin),
                            plan, t_fail, used)


def double_retry(plan: AllocationPlan, t_fail: float, used: float,
                 *, cap: float = np.inf) -> AllocationPlan:
    """PPM-Improved / nf-core default: double the allocation (capped)."""
    return apply_retry_spec(RetrySpec("double"), plan, t_fail, used,
                            machine_memory=cap)


def max_machine_retry(plan: AllocationPlan, t_fail: float, used: float,
                      *, machine_memory: float) -> AllocationPlan:
    """Tovar-PPM: on failure, allocate the whole machine."""
    return apply_retry_spec(RetrySpec("max-machine"), plan, t_fail, used,
                            machine_memory=machine_memory)
