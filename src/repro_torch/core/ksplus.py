"""KS+ — the paper's method, as a composable module.

Usage::

    model = KSPlus(k=4)
    model.fit(mems, dts, inputs)          # historical executions of one task
    plan = model.predict(input_size)      # AllocationPlan (monotone step fn)
    plan = model.retry(plan, t_fail, used)  # §II-C failure handling
    model.observe(ExecutionOutcome(...))  # feed a finished execution back
    model.refit("on_failure")             # maybe re-fit from the history

Every method (KS+ and the baselines in :mod:`repro_torch.core.baselines`)
subclasses :class:`repro_torch.core.predictor.MemoryPredictor` — the explicit
``fit / observe / refit / predict / retry`` lifecycle — so the simulator,
the online replay harness and the benchmark suite treat them uniformly.
Construction and naming run through :mod:`repro_torch.core.registry`.
Fitting runs on each method's ``device`` (None means the card).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.fleet import RetrySpec
from repro_torch.core.predictor import (
    ExecutionOutcome,
    MemoryPredictor,
    RefitPolicy,
    SegmentModel,
    predict_plan,
    predict_plans_packed,
    predict_runtime,
    segment_rows,
    solve_segment_model,
)
from repro_torch.core.retry import ksplus_retry
from repro_torch.device import resolve_device

__all__ = ["ExecutionOutcome", "MemoryPredictor", "RefitPolicy",
           "HeteroDtWarning", "reset_hetero_dt_warnings",
           "KSPlus", "KSPlusAuto"]


class HeteroDtWarning(UserWarning):
    """Heterogeneous per-execution ``dt`` values hit a batched-engine path
    that needs a resample/fallback policy (see :class:`KSPlusAuto`)."""


# Deduplication registry for HeteroDtWarning: a 10k-task hetero-dt scenario
# fits one KSPlusAuto per task family, and every one of those fits would
# repeat the same diagnosis — the situation is a property of the *workload*,
# so identical (policy, target-dt) situations warn once per process.
_HETERO_WARNED: set = set()


def reset_hetero_dt_warnings() -> None:
    """Clear the :class:`HeteroDtWarning` dedup registry (tests; or after
    switching workloads, to re-surface the diagnosis once)."""
    _HETERO_WARNED.clear()


def _warn_hetero_once(policy: str, dt0: float, message: str) -> None:
    key = (policy, float(dt0))
    if key in _HETERO_WARNED:
        return
    _HETERO_WARNED.add(key)
    warnings.warn(message, HeteroDtWarning, stacklevel=3)


def _resample_trace(mem: np.ndarray, dt: float, dt0: float) -> np.ndarray:
    """Sample-and-hold resampling of a trace from period ``dt`` to ``dt0``.

    Sample ``i`` of the result reads the source sample active at
    ``i * dt0`` — exact for the step-function envelopes this system
    models; total duration is preserved to within one target sample.
    """
    if dt == dt0:
        return mem
    n_new = max(int(np.ceil(len(mem) * dt / dt0 - 1e-9)), 1)
    idx = np.minimum((np.arange(n_new) * dt0 / dt).astype(np.int64),
                     len(mem) - 1)
    return np.asarray(mem)[idx]


@dataclasses.dataclass
class KSPlus(MemoryPredictor):
    """The KS+ method (dynamic segments + per-segment regression + re-timing).

    Attributes:
      k:            number of segments (paper sweeps 2–8; Fig. 7 minimum at 6).
      peak_offset:  over-prediction margin on segment peaks (+10 %).
      start_offset: under-prediction margin on segment starts (−15 %).
      last_peak_bump: peak increase when failing inside the last segment.
    """

    k: int = 4
    peak_offset: float = 0.10
    start_offset: float = 0.15
    last_peak_bump: float = 0.20
    device: object = None  # where fitting runs; None means the card
    _model: Optional[SegmentModel] = dataclasses.field(default=None, repr=False)
    # Cached per-execution segmentation rows (starts_sec, peaks, runtimes,
    # inputs) for the fitted history — the incremental state online refits
    # extend instead of re-segmenting everything.
    _rows: Optional[tuple] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _fit(self, mems, dts, inputs) -> None:
        ss, pk, rt = segment_rows(mems, dts, self.k, device=self.device)
        self._rows = (ss, pk, rt, np.asarray(inputs, np.float64))
        self._solve()

    def _solve(self) -> None:
        ss, pk, rt, I = self._rows
        self._model = solve_segment_model(
            I, ss, pk, rt, self.k,
            peak_offset=self.peak_offset, start_offset=self.start_offset,
            device=self.device,
        )

    def _segment_tail(self):
        st = self._life
        have = 0 if self._rows is None else len(self._rows[3])
        if self._rows is None or have > len(st.mems):
            return None  # cache diverged from history: full refit
        return st.mems[have:], st.dts[have:], self.k

    def _commit_tail_rows(self, ss, pk, rt) -> None:
        st = self._life
        have = len(self._rows[3])
        I2 = np.asarray(st.inputs[have:], np.float64)
        self._rows = tuple(
            np.concatenate([a, b])
            for a, b in zip(self._rows, (ss, pk, rt, I2)))
        self._solve()

    def _refit(self) -> None:
        """Incremental online refit: Algorithm 1 is per-execution, so only
        the newly observed tail is segmented; the regressions re-solve over
        the cached rows — bit-identical to a from-scratch ``_fit`` on the
        full history, at O(new executions) cost."""
        tail = self._segment_tail()
        if tail is None:
            return super()._refit()
        mems, dts, k = tail
        if mems:
            self._commit_tail_rows(*segment_rows(mems, dts, k,
                                                 device=self.device))
        else:
            self._solve()

    @property
    def model(self) -> SegmentModel:
        if self._model is None:
            raise RuntimeError("KSPlus.fit() must be called before predict()")
        return self._model

    def predict(self, input_size: float) -> AllocationPlan:
        return predict_plan(self.model, input_size)

    def predict_packed(self, inputs: np.ndarray):
        """Vectorized predict: (starts, peaks) of shape (B, k)."""
        return predict_plans_packed(self.model, inputs)

    def predict_runtime(self, input_size: float) -> float:
        return predict_runtime(self.model, input_size)

    def retry(self, plan: AllocationPlan, t_fail: float,
              used: float) -> AllocationPlan:
        return ksplus_retry(plan, t_fail, used,
                            last_peak_bump=self.last_peak_bump)

    @property
    def retry_spec(self) -> RetrySpec:
        return RetrySpec("ksplus", bump=self.last_peak_bump)


@dataclasses.dataclass
class KSPlusAuto(MemoryPredictor):
    """KS+ with per-task automatic segment-count selection.

    The paper's stated future work ("dynamically determine the optimal
    number of segments for each task"): fit one KS+ model per candidate k,
    replay the *training* executions through the OOM/retry simulator, and
    keep the k with the lowest training wastage.

    The replay runs on the batched fleet engine with the candidate axis
    folded into the lane batch — one fleet call over ``device`` evaluates
    every ``(candidate k, training execution)`` pair at once instead of |K|
    serial Python replays.  Set ``engine="oracle"`` to force the
    per-execution loop.

    The fleet engine's lane batch shares one sampling period, so
    heterogeneous per-execution ``dt`` values need a policy
    (``hetero_dt``, only consulted when ``engine="fleet"`` and the ``dts``
    actually differ — a :class:`HeteroDtWarning` is emitted either way,
    deduplicated per (policy, target dt) per process so a 10k-task
    hetero-dt scenario diagnoses the situation once, not once per task
    family; :func:`reset_hetero_dt_warnings` re-arms it):

    * ``"resample"`` (default) — sample-and-hold every training trace onto
      the finest observed ``dt`` and select k on the batched engine.  The
      envelope is a step function, so resampling preserves its shape; only
      OOM *timing* inside one coarse sample can shift, which perturbs the
      candidates' training-wastage totals equally and leaves the argmin
      (the chosen k) stable in practice.
    * ``"oracle"`` — replay each execution at its native ``dt`` through the
      per-execution Python loop (exact, |candidates|× slower).
    """

    candidates: Sequence[int] = (2, 3, 4, 6, 8)
    peak_offset: float = 0.10
    start_offset: float = 0.15
    last_peak_bump: float = 0.20
    machine_memory: float = 128.0
    engine: str = "fleet"
    hetero_dt: str = "resample"
    chosen_k: Optional[int] = None
    device: object = None  # where fitting and k selection run; None = card
    _model: Optional[KSPlus] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _fit(self, mems, dts, inputs) -> None:
        if self.hetero_dt not in ("resample", "oracle"):
            raise ValueError(
                f"unknown hetero_dt policy: {self.hetero_dt!r} "
                "(expected 'resample' or 'oracle')")
        models = []
        for k in self.candidates:
            m = KSPlus(k=k, peak_offset=self.peak_offset,
                       start_offset=self.start_offset,
                       last_peak_bump=self.last_peak_bump,
                       device=self.device)
            m.fit(mems, dts, inputs)
            models.append(m)

        uniform_dt = len(set(float(d) for d in dts)) == 1
        if self.engine != "fleet":
            totals = self._training_wastage_oracle(models, mems, dts, inputs)
        elif uniform_dt:
            totals = self._training_wastage_fleet(models, mems, dts, inputs)
        elif self.hetero_dt == "resample":
            dt0 = float(min(float(d) for d in dts))
            _warn_hetero_once(
                "resample", dt0,
                "KSPlusAuto.fit: executions have heterogeneous dt values; "
                f"resampling training traces to the finest dt ({dt0}) for "
                "the batched k-selection replay (hetero_dt='resample'; use "
                "hetero_dt='oracle' for exact native-dt replays).  Warned "
                "once per process for this situation — see "
                "repro_torch.core.ksplus.reset_hetero_dt_warnings")
            resampled = [_resample_trace(m_, float(d), dt0)
                         for m_, d in zip(mems, dts)]
            totals = self._training_wastage_fleet(
                models, resampled, [dt0] * len(mems), inputs)
        else:  # hetero_dt == "oracle" (validated above)
            _warn_hetero_once(
                "oracle", 0.0,
                "KSPlusAuto.fit: executions have heterogeneous dt values; "
                "falling back to the per-execution oracle replay "
                "(hetero_dt='oracle').  Warned once per process — see "
                "repro_torch.core.ksplus.reset_hetero_dt_warnings")
            totals = self._training_wastage_oracle(models, mems, dts, inputs)

        best = (np.inf, None, None)
        for k, m, total in zip(self.candidates, models, totals):
            if total < best[0]:
                best = (total, k, m)
        _, self.chosen_k, self._model = best

    def _training_wastage_fleet(self, models, mems, dts, inputs):
        """One engine call: candidates become an extra lane-batch axis."""
        from repro_torch.core.fleet import concat_packed, packed_predict, \
            simulate_fleet
        packed = concat_packed(
            [packed_predict(m, inputs) for m in models])
        fr = simulate_fleet(
            packed, RetrySpec("ksplus", bump=self.last_peak_bump),
            list(mems) * len(models), float(dts[0]),
            machine_memory=self.machine_memory, device=self.device)
        return fr.wastage_gbs.reshape(len(models), len(inputs)).sum(axis=1)

    def _training_wastage_oracle(self, models, mems, dts, inputs):
        from repro_torch.core.wastage import simulate_execution  # cycle-free import
        totals = []
        for m in models:
            total = 0.0
            for mem, dt, inp in zip(mems, dts, inputs):
                res = simulate_execution(
                    m.predict(inp), m.retry, mem, dt,
                    machine_memory=self.machine_memory)
                total += res.wastage_gbs
            totals.append(total)
        return totals

    def observe(self, outcome: ExecutionOutcome) -> None:
        super().observe(outcome)
        if self._model is not None:  # mirror into the selected model's
            self._model.observe(outcome)  # incremental lifecycle state

    def _segment_tail(self):
        # Batched-refit protocol: delegate to the selected model (its
        # lifecycle mirrors this one's via `observe`).
        return None if self._model is None else self._model._segment_tail()

    def _commit_tail_rows(self, ss, pk, rt) -> None:
        self._model._commit_tail_rows(ss, pk, rt)
        self._model._life.pending = 0
        self._model._life.failures = 0

    def _refit(self) -> None:
        """Online refit: re-estimate the regressions at the *selected* k
        (incrementally, through the inner model's own lifecycle).

        Re-running the |candidates|× training-replay sweep on every online
        refit would dominate streaming replays (it is a full fleet
        simulation of the whole history per candidate); the segment count
        is a structural property of the task family, so it is re-selected
        only by an explicit :meth:`fit`.
        """
        if self._model is None:  # never fitted: fall back to full selection
            return super()._refit()
        self._model.refit(RefitPolicy("every_n", 1))

    @property
    def model(self) -> KSPlus:
        if self._model is None:
            raise RuntimeError(
                "KSPlusAuto.fit() must be called before predict()")
        return self._model

    def predict(self, input_size: float) -> AllocationPlan:
        return self.model.predict(input_size)

    def predict_packed(self, inputs: np.ndarray):
        return self.model.predict_packed(inputs)

    def predict_runtime(self, input_size: float) -> float:
        return self.model.predict_runtime(input_size)

    def retry(self, plan, t_fail, used) -> AllocationPlan:
        return self.model.retry(plan, t_fail, used)

    @property
    def retry_spec(self) -> RetrySpec:
        return self.model.retry_spec
