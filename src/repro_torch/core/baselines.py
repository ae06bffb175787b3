"""State-of-the-art baselines evaluated in the paper (§III-B).

* :class:`TovarPPM` — Tovar et al. peak-probability sizing; on failure the
  whole machine is allocated for the re-execution.
* :class:`TovarFeedback` — Tovar's *full* feedback loop: the empirical
  peak distribution is carried across executions as online state, so every
  observed outcome (success or OOM) sharpens the next first allocation.
* :class:`PPMImproved` — same first allocation, but doubling on failure.
* :class:`KSegments` — the original k-Segments method (equal-length segments
  over a predicted runtime) with the 'Selective' / 'Partial' retry variants.
* :class:`WittPercentile` — Witt et al. percentile-of-peaks sizing with
  doubling on failure (the feedback-loop baseline family).
* :class:`DefaultMethod` — the workflow developers' static limits with the
  standard retry-with-doubled-memory behaviour.

All subclass :class:`repro_torch.core.predictor.MemoryPredictor` — the explicit
``fit / observe / refit / predict / retry`` lifecycle — and are registered
(with their capability flags) in :mod:`repro_torch.core.registry`, which is also
the single source of their display names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.fleet import RetrySpec
from repro_torch.core.predictor import (
    ExecutionOutcome,
    LinReg,
    MemoryPredictor,
    fit_linreg,
)
from repro_torch.core.retry import (
    double_retry,
    ksegments_partial_retry,
    ksegments_selective_retry,
    max_machine_retry,
)
from repro_torch.device import resolve_device

__all__ = ["TovarPPM", "TovarFeedback", "PPMImproved", "KSegments",
           "WittPercentile", "DefaultMethod"]


def _constant_plan(value: float) -> AllocationPlan:
    return AllocationPlan(starts=np.zeros(1), peaks=np.asarray([value]))


def _ppm_first_alloc(peaks: np.ndarray, runtimes: np.ndarray,
                     machine_memory: float) -> float:
    """Tovar's peak-probability sizing: the candidate allocation minimizing
    expected allocated GB·s under the empirical peak distribution, assuming
    failures surface at the end of a run (slow-peaks model) and are retried
    with the machine's full memory:
    ``cost(a) = sum_e a*r_e + sum_{p_e > a} M_max * r_e``."""
    candidates = np.unique(peaks)
    fail = peaks[None, :] > candidates[:, None] + 1e-12
    cost = candidates * runtimes.sum() + (
        fail * (machine_memory * runtimes)[None, :]
    ).sum(axis=1)
    return float(candidates[int(np.argmin(cost))])


@dataclasses.dataclass
class TovarPPM(MemoryPredictor):
    """Peak-probability model: pick the first allocation minimizing expected
    allocated GB·s under the empirical peak distribution, assuming failures
    surface at the end of a run (slow-peaks model) and are retried with the
    machine's full memory."""

    machine_memory: float = 128.0
    _first_alloc: float = dataclasses.field(default=0.0, repr=False)

    def _fit(self, mems: Sequence[np.ndarray], dts, inputs) -> None:
        peaks = np.asarray([float(np.max(m)) for m in mems])
        runtimes = np.asarray([len(m) * dt for m, dt in zip(mems, dts)])
        self._first_alloc = _ppm_first_alloc(peaks, runtimes,
                                             self.machine_memory)

    def predict(self, input_size: float) -> AllocationPlan:
        return _constant_plan(self._first_alloc)

    def predict_packed(self, inputs: np.ndarray):
        B = len(inputs)
        return np.zeros((B, 1)), np.full((B, 1), self._first_alloc)

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return max_machine_retry(plan, t_fail, used,
                                 machine_memory=self.machine_memory)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("max-machine")


@dataclasses.dataclass
class TovarFeedback(MemoryPredictor):
    """Tovar's full feedback loop: peak-distribution state across executions.

    Same sizing rule and whole-machine retry as :class:`TovarPPM`, but the
    empirical ``(peak, runtime)`` distribution is *online state*: every
    :meth:`observe` appends the outcome's peak and runtime (O(1) summary —
    traces are not retained, ``_needs_traces = False``), and :meth:`refit`
    re-solves the expected-cost minimization over the accumulated
    distribution.  Under ``refit="on_failure"`` an OOMed execution (whose
    whole-machine retry is exactly what the cost model prices) immediately
    raises the next first allocation, which is where this method beats the
    fit-once ``tovar-ppm`` on drifting or under-sampled task families.
    """

    machine_memory: float = 128.0
    _needs_traces = False
    _first_alloc: float = dataclasses.field(default=0.0, repr=False)
    # Python lists on purpose: observe is truly O(1) amortized; arrays
    # materialize only when a refit actually re-solves.
    _peaks: list = dataclasses.field(default_factory=list, repr=False)
    _runtimes: list = dataclasses.field(default_factory=list, repr=False)

    def _fit(self, mems: Sequence[np.ndarray], dts, inputs) -> None:
        self._peaks = [float(np.max(m)) for m in mems]
        self._runtimes = [len(m) * dt for m, dt in zip(mems, dts)]
        self._solve()

    def observe(self, outcome: ExecutionOutcome) -> None:
        super().observe(outcome)
        self._peaks.append(outcome.peak)
        self._runtimes.append(outcome.runtime)

    def _refit(self) -> None:
        # Refit consumes the carried summary state, not raw traces.
        self._solve()

    def _solve(self) -> None:
        self._first_alloc = _ppm_first_alloc(
            np.asarray(self._peaks), np.asarray(self._runtimes),
            self.machine_memory)

    def predict(self, input_size: float) -> AllocationPlan:
        return _constant_plan(self._first_alloc)

    def predict_packed(self, inputs: np.ndarray):
        B = len(inputs)
        return np.zeros((B, 1)), np.full((B, 1), self._first_alloc)

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return max_machine_retry(plan, t_fail, used,
                                 machine_memory=self.machine_memory)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("max-machine")


@dataclasses.dataclass
class PPMImproved(MemoryPredictor):
    """Tovar-PPM's sizing with doubling instead of whole-machine retries."""

    machine_memory: float = 128.0
    _inner: Optional[TovarPPM] = dataclasses.field(default=None, repr=False)

    def _fit(self, mems, dts, inputs) -> None:
        self._inner = TovarPPM(machine_memory=self.machine_memory)
        self._inner.fit(mems, dts, inputs)

    def predict(self, input_size: float) -> AllocationPlan:
        return self._inner.predict(input_size)

    def predict_packed(self, inputs: np.ndarray):
        return self._inner.predict_packed(inputs)

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return double_retry(plan, t_fail, used, cap=self.machine_memory)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("double")


@dataclasses.dataclass
class KSegments(MemoryPredictor):
    """The original k-Segments method [19] (the paper's direct predecessor).

    Runtime is predicted by linear regression on input size and divided into
    ``k`` *equal* segments; each segment's peak is predicted by its own
    linear regression.  No monotonicity is enforced (that is a KS+ feature),
    so the envelope can step down — exactly the failure mode KS+ removes.
    """

    k: int = 4
    variant: str = "selective"  # or "partial"
    peak_offset: float = 0.10
    runtime_offset: float = 0.15
    device: object = None  # where the regressions run; None means the card
    _runtime_reg: Optional[LinReg] = dataclasses.field(default=None, repr=False)
    _peak_reg: Optional[LinReg] = dataclasses.field(default=None, repr=False)
    # Cached per-execution rows (runtimes, segment peaks, inputs): the
    # incremental unit of online refits (segmentation is per-execution).
    _rows: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _seg_rows(self, mems, dts):
        runtimes = np.asarray([len(m) * dt for m, dt in zip(mems, dts)],
                              np.float64)
        peaks = np.zeros((len(mems), self.k))
        for e, m in enumerate(mems):
            bounds = np.linspace(0, len(m), self.k + 1).astype(int)
            for i in range(self.k):
                lo, hi = bounds[i], max(bounds[i + 1], bounds[i] + 1)
                peaks[e, i] = np.max(m[lo:hi])
        return runtimes, peaks

    def _fit(self, mems, dts, inputs) -> None:
        rt, pk = self._seg_rows(mems, dts)
        self._rows = (rt, pk, np.asarray(inputs, np.float64))
        self._solve()

    def _solve(self) -> None:
        # One call for runtime + k peak regressions (per-column solve:
        # equal to separate calls).
        rt, pk, I = self._rows
        reg = fit_linreg(I, np.concatenate([rt[:, None], pk], axis=1),
                         device=self.device)
        self._runtime_reg = LinReg(slope=reg.slope[0],
                                   intercept=reg.intercept[0])
        self._peak_reg = LinReg(slope=reg.slope[1:], intercept=reg.intercept[1:])

    def _refit(self) -> None:
        """Incremental online refit: segment only the new tail, re-solve
        the regressions over cached rows (== a from-scratch fit)."""
        st = self._life
        have = 0 if self._rows is None else len(self._rows[2])
        if self._rows is None or have > len(st.mems):
            return super()._refit()
        if have < len(st.mems):
            rt, pk = self._seg_rows(st.mems[have:], st.dts[have:])
            I2 = np.asarray(st.inputs[have:], np.float64)
            self._rows = tuple(
                np.concatenate([a, b])
                for a, b in zip(self._rows, (rt, pk, I2)))
        self._solve()

    def predict(self, input_size: float) -> AllocationPlan:
        rt = max(float(self._runtime_reg(input_size)), 0.0)
        rt *= 1.0 - self.runtime_offset  # under-predict segment starts
        starts = np.arange(self.k, dtype=np.float64) * (rt / self.k)
        peaks = np.maximum(
            self._peak_reg(input_size) * (1.0 + self.peak_offset), 1e-6
        )
        return AllocationPlan(starts=starts, peaks=peaks)

    def predict_packed(self, inputs: np.ndarray):
        """Vectorized predict — elementwise bit-identical to per-input calls
        (the regression runs in its own dtype, the runtime math in float64,
        exactly like the scalar path's promotions)."""
        I = np.asarray(inputs, self._runtime_reg.slope.dtype)
        rt = self._runtime_reg(I).astype(np.float64)
        rt = np.maximum(rt, 0.0) * (1.0 - self.runtime_offset)
        starts = np.arange(self.k, dtype=np.float64)[None, :] \
            * (rt[:, None] / self.k)
        peaks = self._peak_reg.slope[None, :] * I[:, None] \
            + self._peak_reg.intercept[None, :]
        peaks = np.maximum(peaks * (1.0 + self.peak_offset), 1e-6)
        return starts, peaks

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        if self.variant == "selective":
            return ksegments_selective_retry(plan, t_fail, used,
                                             margin=self.peak_offset)
        return ksegments_partial_retry(plan, t_fail, used,
                                       margin=self.peak_offset)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec(f"kseg-{self.variant}", margin=self.peak_offset)


@dataclasses.dataclass
class WittPercentile(MemoryPredictor):
    """Witt et al. percentile predictors: size the first allocation at the
    q-th percentile of the observed peak distribution and double on failure.

    The classic feedback-loop baseline family ("Feedback-based resource
    allocation for workflow applications"): no time structure, just a
    quantile of history — deliberately over-allocating for the top
    ``100 - percentile`` percent of executions instead of modelling when
    memory is needed.  One :class:`RetrySpec` + ``predict_packed`` pair, so
    the fleet engine and the packed cluster scheduler run it unchanged.
    """

    percentile: float = 95.0
    machine_memory: float = 128.0
    _first_alloc: float = dataclasses.field(default=0.0, repr=False)

    def _fit(self, mems: Sequence[np.ndarray], dts, inputs) -> None:
        peaks = np.asarray([float(np.max(m)) for m in mems])
        self._first_alloc = float(np.percentile(peaks, self.percentile))

    def predict(self, input_size: float) -> AllocationPlan:
        return _constant_plan(self._first_alloc)

    def predict_packed(self, inputs: np.ndarray):
        B = len(inputs)
        return np.zeros((B, 1)), np.full((B, 1), self._first_alloc)

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return double_retry(plan, t_fail, used, cap=self.machine_memory)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("double")


@dataclasses.dataclass
class DefaultMethod(MemoryPredictor):
    """Workflow developers' static limit + retry-with-doubled-memory."""

    limit_gb: float
    machine_memory: float = 128.0
    _needs_traces = False

    def _fit(self, mems, dts, inputs) -> None:  # nothing to learn
        pass

    def predict(self, input_size: float) -> AllocationPlan:
        return _constant_plan(self.limit_gb)

    def predict_packed(self, inputs: np.ndarray):
        B = len(inputs)
        return np.zeros((B, 1)), np.full((B, 1), float(self.limit_gb))

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return double_retry(plan, t_fail, used, cap=self.machine_memory)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("double")
