"""KS+ core — the paper's contribution as a composable PyTorch module.

Public API:

* :func:`get_segments` / :func:`get_segments_ref` — Algorithm 1.
* :class:`AllocationPlan` — time-varying allocation step function.
* :class:`KSPlus` — the full method (fit / predict / retry).
* Baselines: :class:`TovarPPM`, :class:`PPMImproved`, :class:`KSegments`,
  :class:`DefaultMethod`.
* :func:`simulate_execution` — OOM/retry simulation + GB·s wastage.
* :func:`simulate_fleet` / :func:`simulate_fleet_many` — the batched
  OOM/retry engine on a device (the CUDA ``oom_probe`` kernel on the card).
"""

from repro_torch.core.allocation import (
    AllocationPlan,
    alloc_at,
    alloc_series,
    first_violation,
)
from repro_torch.core.baselines import (
    DefaultMethod,
    KSegments,
    PPMImproved,
    TovarFeedback,
    TovarPPM,
    WittPercentile,
)
from repro_torch.core.envelope import (
    OffsetCandidate,
    PackedEnvelopes,
    alloc_at_packed,
    apply_offsets,
    first_violation_packed,
    fits_under,
    residual_over,
    retry_packed,
    segment_sample_bounds,
    span_alloc_sum,
    usage_over,
)
from repro_torch.core.fleet import (
    FleetBatch,
    FleetResult,
    PackedTraces,
    RetrySpec,
    TraceBucket,
    bucket_traces,
    concat_packed,
    pack_plans,
    pack_traces,
    packed_predict,
    simulate_fleet,
    simulate_fleet_many,
    subset_batch,
)
from repro_torch.core.ksplus import KSPlus, KSPlusAuto
from repro_torch.core.predictor import (
    ExecutionOutcome,
    LinReg,
    MemoryPredictor,
    RefitPolicy,
    SegmentModel,
    fit_linreg,
    fit_segment_model,
    predict_plan,
    predict_runtime,
    refit_batched,
    segment_rows,
    solve_segment_model,
)
from repro_torch.core import registry
from repro_torch.core.retry import (
    double_retry,
    ksegments_partial_retry,
    ksegments_selective_retry,
    ksplus_retry,
    max_machine_retry,
)
from repro_torch.core.segmentation import get_segments, get_segments_ref, segments_to_starts
from repro_torch.core.wastage import (
    AttemptRecord,
    ExecutionResult,
    oom_probe_ref,
    simulate_execution,
    wastage_eval_ref,
)

__all__ = [
    "AllocationPlan", "alloc_at", "alloc_series", "first_violation",
    "DefaultMethod", "KSegments", "PPMImproved", "TovarFeedback", "TovarPPM",
    "WittPercentile",
    "OffsetCandidate", "PackedEnvelopes", "alloc_at_packed", "apply_offsets",
    "first_violation_packed",
    "fits_under", "residual_over", "retry_packed", "segment_sample_bounds",
    "span_alloc_sum", "usage_over",
    "FleetBatch", "FleetResult", "PackedTraces", "RetrySpec", "TraceBucket",
    "bucket_traces", "concat_packed",
    "pack_plans", "pack_traces", "packed_predict", "simulate_fleet",
    "simulate_fleet_many", "subset_batch",
    "ExecutionOutcome", "KSPlus", "KSPlusAuto", "MemoryPredictor",
    "RefitPolicy", "refit_batched", "registry",
    "LinReg", "SegmentModel", "fit_linreg", "fit_segment_model",
    "predict_plan", "predict_runtime", "segment_rows", "solve_segment_model",
    "double_retry", "ksegments_partial_retry", "ksegments_selective_retry",
    "ksplus_retry", "max_machine_retry",
    "get_segments", "get_segments_ref", "segments_to_starts",
    "AttemptRecord", "ExecutionResult", "simulate_execution",
    "wastage_eval_ref", "oom_probe_ref",
]
