"""Seeded arrival processes: per-job release times, decoupled from DAG
structure.

A workload's *structure* (which tasks depend on which) and its *timing*
(when root work shows up at the cluster) are independent axes; these
helpers generate the timing.  Each returns a ``(B,)`` float64 array of
release times suitable for :func:`with_arrivals` /
``WorkflowTrace.release_times`` — non-root tasks keep 0.0, since a
child's effective release is gated by its parents finishing (the
simulator takes ``max`` implicitly: a child released before its parents
finish simply queues at the parent-finish event).

Generators are seeded and deterministic (``numpy.random.Generator`` over
tagged ``SeedSequence``s), so the robustness suite's differential runs
see identical timelines in every engine.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["poisson_arrivals", "diurnal_arrivals", "trace_arrivals",
           "with_arrivals"]


def _roots_mask(B: int, parents) -> np.ndarray:
    if parents is None:
        return np.ones(B, bool)
    return np.asarray([len(p) == 0 for p in parents], bool)


def poisson_arrivals(B: int, rate: float, seed: int = 0,
                     parents=None) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` jobs/second.

    Root tasks receive the cumulative-exponential arrival times in task
    order; non-root tasks stay at 0.0 (DAG-gated).
    """
    if rate <= 0.0:
        raise ValueError(f"poisson_arrivals needs rate > 0, got {rate!r}")
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xA221]))
    roots = _roots_mask(B, parents)
    out = np.zeros(B, np.float64)
    out[roots] = np.cumsum(rng.exponential(1.0 / rate, int(roots.sum())))
    return out


def diurnal_arrivals(B: int, base_rate: float, period: float = 86_400.0,
                     depth: float = 0.8, seed: int = 0,
                     parents=None) -> np.ndarray:
    """Non-homogeneous Poisson with a sinusoidal day/night intensity.

    Intensity ``lam(t) = base_rate * (1 + depth * sin(2 pi t / period))``
    sampled by thinning: candidates arrive at the peak rate
    ``base_rate * (1 + depth)`` and are accepted with probability
    ``lam(t) / peak`` — the standard exact construction, so the accepted
    stream is the true inhomogeneous process.
    """
    if base_rate <= 0.0 or not (0.0 <= depth < 1.0):
        raise ValueError("diurnal_arrivals needs base_rate > 0 and "
                         "0 <= depth < 1")
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xD1C4]))
    peak = base_rate * (1.0 + depth)
    roots = _roots_mask(B, parents)
    n = int(roots.sum())
    times = np.zeros(n, np.float64)
    t = 0.0
    for i in range(n):
        while True:
            t += float(rng.exponential(1.0 / peak))
            lam = base_rate * (1.0 + depth * np.sin(2.0 * np.pi * t / period))
            if rng.uniform() * peak <= lam:
                break
        times[i] = t
    out = np.zeros(B, np.float64)
    out[roots] = times
    return out


def trace_arrivals(B: int, times: Sequence[float],
                   parents=None) -> np.ndarray:
    """Trace-driven arrivals: replay recorded submit times.

    ``times`` must cover the workload's root tasks (extra entries are
    ignored; too few is an error — silently recycling a short trace would
    fabricate burst structure that was never measured).  Times are
    normalized so the earliest root releases at 0.0.
    """
    roots = _roots_mask(B, parents)
    n = int(roots.sum())
    times = np.asarray(list(times), np.float64)
    if len(times) < n:
        raise ValueError(
            f"trace_arrivals: trace has {len(times)} times but the "
            f"workload has {n} root tasks")
    if not np.isfinite(times[:n]).all() or (times[:n] < 0.0).any():
        raise ValueError("trace_arrivals: times must be finite and >= 0")
    sel = np.sort(times[:n])
    out = np.zeros(B, np.float64)
    out[roots] = sel - sel[0]
    return out


def with_arrivals(trace, release_times: Optional[np.ndarray]):
    """A copy of ``trace`` (a :class:`~repro_torch.workloads.WorkflowTrace`)
    carrying ``release_times``; ``None`` clears them (everything at 0)."""
    if release_times is not None:
        release_times = np.asarray(release_times, np.float64)
        if release_times.shape != (trace.B,):
            raise ValueError(
                f"release_times shape {release_times.shape} != ({trace.B},)")
    return dataclasses.replace(trace, release_times=release_times)
