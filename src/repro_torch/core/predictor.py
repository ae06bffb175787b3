"""Per-segment linear-regression predictors (KS+ §II-B).

For each task type we segment every historical execution with Algorithm 1
(k segments), then fit — *per segment index i* — two univariate linear
regressions on the execution's aggregated input size ``I``:

    start_i ~ a_i * I + b_i        (segment start offset, seconds)
    peak_i  ~ c_i * I + d_i        (segment peak memory, GB)

Safety offsets (paper §II-B): peaks are over-predicted by ``peak_offset``
(+10 %) and start times under-predicted by ``start_offset`` (−15 %); with a
monotone envelope, stepping up early is always safe.

The fitting path is batched PyTorch on ``device`` (None means the card):
all executions of a task are padded to a common length and segmented by one
batched :func:`repro_torch.core.segmentation.get_segments` call, and the
2k+1 regressions are solved in closed form, float32, in one vectorized
expression over the columns.  Prediction (:func:`predict_plans_packed`)
stays host numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.allocation import AllocationPlan
from repro_torch.core.segmentation import get_segments
from repro_torch.device import resolve_device

__all__ = [
    "ExecutionOutcome",
    "RefitPolicy",
    "MemoryPredictor",
    "refit_batched",
    "LinReg",
    "fit_linreg",
    "SegmentModel",
    "segment_rows",
    "solve_segment_model",
    "fit_segment_model",
    "predict_plan",
    "predict_plans_packed",
    "pad_obs_axis",
]


# ------------------------------------------------------------- lifecycle API
@dataclasses.dataclass(frozen=True)
class ExecutionOutcome:
    """One finished execution, as fed back into a predictor's online state.

    ``mem`` is the monitoring trace of the execution (GB per ``dt`` sample),
    ``succeeded`` whether the *replay* of that execution under the method's
    plans eventually succeeded (False = it exhausted its attempts or the
    machine), ``retries`` how many attempts were OOM-killed on the way, and
    ``peak_used`` the highest observed usage — defaulted from the trace
    when omitted.
    """

    mem: np.ndarray
    dt: float
    input_gb: float
    succeeded: bool = True
    retries: int = 0
    peak_used: Optional[float] = None

    @property
    def oomed(self) -> bool:
        """Did the OOM killer fire at least once (even if a retry then
        succeeded)?  This is the failure signal ``refit="on_failure"``
        triggers on — a method whose retry rule always rescues the
        execution would otherwise never see its own misses."""
        return self.retries > 0 or not self.succeeded

    @property
    def peak(self) -> float:
        if self.peak_used is not None:
            return float(self.peak_used)
        return float(np.max(self.mem))

    @property
    def runtime(self) -> float:
        return len(self.mem) * float(self.dt)


@dataclasses.dataclass(frozen=True)
class RefitPolicy:
    """When :meth:`MemoryPredictor.refit` actually re-fits.

    * ``"never"``      — today's offline behaviour: fit once, replay many.
    * ``"every_n"``    — re-fit once ``n`` new outcomes have been observed.
    * ``"on_failure"`` — re-fit as soon as an observed outcome failed.

    Accepts the string forms ``"never"``, ``"on_failure"``, ``"every_n"``
    (n defaults to 1) and ``"every_<n>"`` (e.g. ``"every_5"``) via
    :meth:`parse`.  Hashable on purpose — policies ride through the
    experiment harness as static configuration.
    """

    kind: str
    n: int = 1

    _KINDS = ("never", "every_n", "on_failure")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown refit policy: {self.kind!r} "
                f"(expected one of {self._KINDS})")
        if self.kind == "every_n" and self.n < 1:
            raise ValueError(f"every_n needs n >= 1, got {self.n}")

    @classmethod
    def parse(cls, policy: Union["RefitPolicy", str]) -> "RefitPolicy":
        if isinstance(policy, cls):
            return policy
        if isinstance(policy, str) and policy.startswith("every_") \
                and policy != "every_n":
            return cls("every_n", int(policy[len("every_"):]))
        return cls(str(policy))

    def due(self, pending: int, failures: int) -> bool:
        """Is a refit due after ``pending`` unconsumed observations of
        which ``failures`` failed?"""
        if self.kind == "never" or pending == 0:
            return False
        if self.kind == "on_failure":
            return failures > 0
        return pending >= self.n


class _Lifecycle:
    """Per-predictor online state: the observed history and refit counters."""

    __slots__ = ("mems", "dts", "inputs", "pending", "failures", "observed")

    def __init__(self):
        self.mems: List[Optional[np.ndarray]] = []
        self.dts: List[float] = []
        self.inputs: List[float] = []
        self.pending = 0    # outcomes observed since the last (re)fit
        self.failures = 0   # of those, how many failed
        self.observed = 0   # lifetime outcome count


class MemoryPredictor:
    """Explicit predictor lifecycle shared by KS+ and every baseline.

    ``fit(mems, dts, inputs)`` (offline bootstrap) → ``observe(outcome)``
    (feed one finished execution into the per-family online state) →
    ``refit(policy)`` (maybe re-fit from the accumulated history) →
    ``predict`` / ``predict_packed`` → ``retry`` / ``retry_spec``.

    Subclasses implement :meth:`_fit` (estimation from raw history) plus
    the prediction/retry surface; the base class owns the history
    bookkeeping so ``refit`` policies behave identically across methods.
    A subclass whose refit consumes summary state instead of raw traces
    (e.g. :class:`repro_torch.core.baselines.TovarFeedback`) sets
    ``_needs_traces = False`` — observed traces are then dropped after the
    summary update, keeping online state O(#executions), not O(samples) —
    and overrides :meth:`_refit`.

    ``name`` resolves through :mod:`repro_torch.core.registry` — the registry is
    the single source of method names (``k-segments-selective``,
    ``witt-p95``, ... are derived there from instance parameters).
    """

    _needs_traces = True

    @property
    def _life(self) -> _Lifecycle:
        st = self.__dict__.get("_lifecycle")
        if st is None:
            st = self.__dict__["_lifecycle"] = _Lifecycle()
        return st

    # ------------------------------------------------------------- estimation
    def _fit(self, mems, dts, inputs) -> None:
        raise NotImplementedError

    def fit(self, mems, dts, inputs) -> None:
        """Offline bootstrap: (re)seed the history and fit from it."""
        st = self._life
        st.mems = [np.asarray(m) for m in mems] if self._needs_traces \
            else [None] * len(mems)
        st.dts = [float(d) for d in dts]
        st.inputs = [float(i) for i in inputs]
        st.pending = 0
        st.failures = 0
        self._fit(mems, dts, inputs)

    def observe(self, outcome: ExecutionOutcome) -> None:
        """Feed one finished execution into the online state."""
        st = self._life
        st.mems.append(np.asarray(outcome.mem) if self._needs_traces
                       else None)
        st.dts.append(float(outcome.dt))
        st.inputs.append(float(outcome.input_gb))
        st.pending += 1
        st.observed += 1
        if outcome.oomed:
            st.failures += 1

    def refit(self, policy: Union[RefitPolicy, str] = "never") -> bool:
        """Re-fit from the accumulated history when ``policy`` says so.

        Returns True iff a refit happened; the pending/failure counters
        reset either way only on refit, so ``every_n`` counts across calls.
        """
        st = self._life
        if not RefitPolicy.parse(policy).due(st.pending, st.failures):
            return False
        self._refit()
        st.pending = 0
        st.failures = 0
        return True

    def _refit(self) -> None:
        """Default refit: re-run :meth:`_fit` over the full history."""
        st = self._life
        self._fit(st.mems, st.dts, st.inputs)

    # Batched-refit protocol (optional): methods whose refit segments a
    # history *tail* (KS+-style) expose the tail so same-event-time refits
    # across many task families compact into one segmentation call.
    def _segment_tail(self):
        """``(tail_mems, tail_dts, k)`` of unconsumed observations, or
        None when this method cannot take the batched path."""
        return None

    def _commit_tail_rows(self, starts_sec, peaks, runtimes) -> None:
        raise NotImplementedError

    # -------------------------------------------------------------- inference
    @property
    def name(self) -> str:
        from repro_torch.core import registry  # deferred: registry imports methods
        return registry.name_of(self)

    def predict(self, input_size: float) -> AllocationPlan:
        raise NotImplementedError

    def retry(self, plan: AllocationPlan, t_fail: float,
              used: float) -> AllocationPlan:
        raise NotImplementedError

    @property
    def retry_spec(self):
        raise NotImplementedError


def refit_batched(methods: Sequence[MemoryPredictor],
                  policy: Union[RefitPolicy, str]) -> List[bool]:
    """Compacted same-event-time refits across many predictors.

    Method-for-method equivalent to calling ``m.refit(policy)`` on each —
    same due test, same rows, same solves — but every due method that
    exposes a segmentation tail (:meth:`MemoryPredictor._segment_tail`)
    has its tail segmented in ONE :func:`segment_rows` call per (segment
    count, device): the per-call cost of Algorithm 1 (a scan over the
    trace batch) amortizes over every task family refitting at this event
    time.  Methods without
    a tail fall back to their own ``_refit``.

    Returns the per-method refit flags (True = refitted).
    """
    pol = RefitPolicy.parse(policy)
    due = [m for m in methods
           if pol.due(m._life.pending, m._life.failures)]
    groups: dict = {}
    fallback = []
    for m in due:
        tail = m._segment_tail()
        if tail is None:
            fallback.append(m)
        else:
            key = (int(tail[2]), str(m.device))
            groups.setdefault(key, []).append((m, tail))
    for (k, _), items in groups.items():
        all_mems = [t for _, (mems, _, _) in items for t in mems]
        all_dts = [d for _, (_, dts, _) in items for d in dts]
        ss, pk, rt = segment_rows(all_mems, all_dts, k,
                                  device=items[0][0].device)
        off = 0
        for m, (mems, _, _) in items:
            n = len(mems)
            m._commit_tail_rows(ss[off:off + n], pk[off:off + n],
                                rt[off:off + n])
            off += n
    for m in fallback:
        m._refit()
    for m in due:
        m._life.pending = 0
        m._life.failures = 0
    due_ids = {id(m) for m in due}
    return [id(m) in due_ids for m in methods]


@dataclasses.dataclass(frozen=True)
class LinReg:
    """y ≈ slope * x + intercept (vectorized over leading dims)."""

    slope: np.ndarray
    intercept: np.ndarray

    def __call__(self, x):
        return self.slope * x + self.intercept


def _lstsq_cols(x: torch.Tensor, Y: torch.Tensor, w: torch.Tensor):
    """Closed-form weighted univariate least squares, one fit per column.

    ``w`` is a 0/1 validity weight over observations — padded rows are
    masked out of every sum (including through ``where``, so garbage or
    non-finite values in padded slots cannot poison the fit).  Degenerate
    x → mean predictor.  Every column sees the arithmetic of its own
    univariate fit, so the solutions equal separate per-column calls.
    """
    pos = w > 0
    x = torch.where(pos, x, 0.0)
    Y = torch.where(pos[:, None], Y, 0.0)
    sw = torch.sum(w)
    xm = torch.sum(w * x) / sw
    ym = torch.sum(w[:, None] * Y, dim=0) / sw
    var = torch.sum(w * (x - xm) ** 2) / sw
    cov = torch.sum(w[:, None] * (x - xm)[:, None] * (Y - ym), dim=0) / sw
    slope = torch.where(var > 1e-18, cov / torch.clamp(var, min=1e-18), 0.0)
    intercept = ym - slope * xm
    return slope, intercept


def pad_obs_axis(n: int, lo: int = 8) -> int:
    """Bucketed observation count: the execution axis of every fitting
    call is padded to a power of two (zero-weighted rows), as in the
    reference package, so a fit's arithmetic does not depend on whether
    the history arrived all at once or in online increments."""
    return max(lo, 1 << (n - 1).bit_length())


def fit_linreg(x: np.ndarray, y: np.ndarray,
               w: Optional[np.ndarray] = None, *, device=None) -> LinReg:
    """Fit y[:, j] ~ x for each column j (or a single vector y).

    Solved in float32 on ``device`` (the reference package's dtype unless
    JAX x64 mode is on).  ``w`` is an optional 0/1 observation weight; the
    observation axis is bucketed to a power of two with zero weights.
    """
    dev = resolve_device(device)
    xh = np.asarray(x, np.float64)
    n = xh.shape[0]
    y2 = np.atleast_2d(np.asarray(y, np.float64))
    ycols = y2 if y2.shape[0] == n and y2.ndim == 2 else y2.T
    wh = np.ones((n,), np.float64) if w is None else np.asarray(w, np.float64)
    np_ = pad_obs_axis(n)
    if np_ != n:
        pad = np_ - n
        xh = np.concatenate([xh, np.zeros(pad)])
        ycols = np.concatenate([ycols, np.zeros((pad, ycols.shape[1]))])
        wh = np.concatenate([wh, np.zeros(pad)])
    f32 = lambda a: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, np.float32), device=dev)
    slope, intercept = _lstsq_cols(f32(xh), f32(ycols), f32(wh))
    slope = slope.cpu().numpy()
    intercept = intercept.cpu().numpy()
    if np.ndim(y) == 1:
        slope, intercept = slope[0], intercept[0]
    return LinReg(slope=slope, intercept=intercept)


@dataclasses.dataclass(frozen=True)
class SegmentModel:
    """Fitted per-segment regressions for one task type."""

    k: int
    start_reg: LinReg   # slopes/intercepts of shape (k,)
    peak_reg: LinReg    # slopes/intercepts of shape (k,)
    runtime_reg: LinReg  # scalar regression, used by the scheduler
    peak_offset: float = 0.10
    start_offset: float = 0.15


def _segment_executions(mems: torch.Tensor, lengths: torch.Tensor, k: int):
    """Algorithm 1 across executions; return absolute starts + peaks."""
    S, P, n = get_segments(mems, lengths, k)  # (N,k), (N,k), (N,)
    starts = torch.cumsum(S, dim=1) - S  # samples
    slot = torch.arange(k, device=mems.device)[None, :]
    real = slot < n[:, None]
    # Pad degenerate slots: start at end-of-run, peak = overall peak, so the
    # regression sees "this execution never reached segment i" as "segment i
    # starts when the run ends and needs no extra memory".
    last_peak = torch.amax(P, dim=1, keepdim=True)
    starts = torch.where(real, starts, lengths[:, None])
    P = torch.where(real, P, last_peak)
    return starts, P


def segment_rows(mems: Sequence[np.ndarray], dts: Sequence[float], k: int,
                 *, device=None):
    """Per-execution segmentation rows: ``(starts_sec, peaks, runtimes)``.

    This is the *incremental unit* of segment-model fitting: an
    execution's row is a pure function of its own trace (Algorithm 1 is
    per-execution), so online refits segment only the newly observed tail
    and re-solve the regressions over cached rows — O(new executions) per
    refit instead of O(history).  Both padded axes are bucketed to powers
    of two, as in the reference package.  Segmentation runs on ``device``.

    Returns float64 arrays of shapes (N, k), (N, k), (N,).
    """
    if not (len(mems) == len(dts)) or not mems:
        raise ValueError("mems/dts must be equal-length and non-empty")
    dev = resolve_device(device)
    N = len(mems)
    T = max(max(len(m) for m in mems), 64)
    T = 1 << (T - 1).bit_length()
    Np = pad_obs_axis(N)
    padded = np.zeros((Np, T), np.float32)
    lengths = np.ones((Np,), np.int32)  # dummy rows: 1-sample zero trace
    for i, m in enumerate(mems):
        padded[i, : len(m)] = m
        lengths[i] = len(m)
    starts_smp, peaks = _segment_executions(
        torch.from_numpy(padded).to(dev), torch.from_numpy(lengths).to(dev),
        k)
    dts_arr = np.asarray(dts, np.float64)
    starts_sec = starts_smp.cpu().numpy().astype(np.float64)[:N] \
        * dts_arr[:, None]
    runtimes = lengths[:N].astype(np.float64) * dts_arr
    return starts_sec, peaks.cpu().numpy().astype(np.float64)[:N], runtimes


def solve_segment_model(
    inputs: Sequence[float],
    starts_sec: np.ndarray,
    peaks: np.ndarray,
    runtimes: np.ndarray,
    k: int,
    *,
    peak_offset: float = 0.10,
    start_offset: float = 0.15,
    device=None,
) -> SegmentModel:
    """Solve the 2k+1 regressions over pre-segmented rows in one call.

    The solve is per-column, so the solutions equal separate
    per-regression calls.
    """
    I = np.asarray(inputs, np.float64)
    ys = np.concatenate([starts_sec, peaks, runtimes[:, None]], axis=1)
    reg = fit_linreg(I, ys, device=device)
    return SegmentModel(
        k=k,
        start_reg=LinReg(slope=reg.slope[:k], intercept=reg.intercept[:k]),
        peak_reg=LinReg(slope=reg.slope[k:2 * k],
                        intercept=reg.intercept[k:2 * k]),
        runtime_reg=LinReg(slope=reg.slope[2 * k],
                           intercept=reg.intercept[2 * k]),
        peak_offset=peak_offset,
        start_offset=start_offset,
    )


def fit_segment_model(
    mems: Sequence[np.ndarray],
    dts: Sequence[float],
    inputs: Sequence[float],
    k: int,
    *,
    peak_offset: float = 0.10,
    start_offset: float = 0.15,
    device=None,
) -> SegmentModel:
    """Fit a :class:`SegmentModel` from raw execution traces
    (:func:`segment_rows` + :func:`solve_segment_model`).

    Args:
      mems:   per-execution memory traces (GB), possibly different lengths.
      dts:    per-execution sampling periods (seconds).
      inputs: per-execution aggregated input sizes (GB).
      k:      number of segments.
    """
    if len(mems) != len(inputs):
        raise ValueError("mems/inputs must be equal-length")
    ss, pk, rt = segment_rows(mems, dts, k, device=device)
    return solve_segment_model(inputs, ss, pk, rt, k,
                               peak_offset=peak_offset,
                               start_offset=start_offset, device=device)


def predict_plan(model: SegmentModel, input_size: float) -> AllocationPlan:
    """Predict the KS+ allocation plan for a new execution.

    Applies the safety offsets, pins the first segment to t=0, and enforces
    monotonicity on both axes (cummax) so the plan never steps down.
    """
    starts = model.start_reg(input_size) * (1.0 - model.start_offset)
    peaks = model.peak_reg(input_size) * (1.0 + model.peak_offset)
    starts = np.maximum.accumulate(np.maximum(starts, 0.0))
    starts[0] = 0.0
    peaks = np.maximum.accumulate(np.maximum(peaks, 1e-6))
    return AllocationPlan(starts=starts, peaks=peaks)


def predict_plans_packed(model: SegmentModel, inputs: np.ndarray):
    """Vectorized :func:`predict_plan` over a batch of input sizes.

    Returns ``(starts, peaks)`` of shape (B, k), elementwise *bit-identical*
    to per-input calls — the input batch is cast to the regression dtype so
    broadcasting reproduces the scalar path's promotion (NumPy keeps python
    scalars "weak", so per-plan math runs in the slope's dtype).  The fleet
    engine consumes these without building plan objects.
    """
    I = np.asarray(inputs, model.start_reg.slope.dtype)[:, None]
    starts = (model.start_reg.slope[None, :] * I
              + model.start_reg.intercept[None, :]) \
        * (1.0 - model.start_offset)
    peaks = (model.peak_reg.slope[None, :] * I
             + model.peak_reg.intercept[None, :]) * (1.0 + model.peak_offset)
    starts = np.maximum.accumulate(np.maximum(starts, 0.0), axis=1)
    starts[:, 0] = 0.0
    peaks = np.maximum.accumulate(np.maximum(peaks, 1e-6), axis=1)
    return starts, peaks


def predict_runtime(model: SegmentModel, input_size: float,
                    margin: float = 0.10) -> float:
    """Scheduler-facing runtime estimate (over-predicted by ``margin``)."""
    return float(max(model.runtime_reg(input_size), 0.0)) * (1.0 + margin)
