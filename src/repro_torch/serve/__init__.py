"""Multi-tenant prediction-as-a-service.

The request path::

    client.predict ──► PredictionServer.submit ──► PredictionCache hit?
            │                                         │ yes: resolve now
            ▼ no                                      ▼
    MicroBatcher (≤ max_wait_s) ──► buckets ──► one batched dispatch per
    bucket (gathered SegmentModel eval / predict_packed on the host;
    simulate_fleet_many → one fleet_engine launch on the card) ──►
    scatter to ServeFutures

Layers: :mod:`~repro_torch.serve.batcher` (coalescing queue),
:mod:`~repro_torch.serve.tenants` (copy-on-refit snapshot state),
:mod:`~repro_torch.serve.cache` (prediction + program/trace caches),
:mod:`~repro_torch.serve.server` (dispatch + the synchronous client),
:mod:`~repro_torch.serve.bench` (the ``serve_saturation`` harness behind
``python -m repro_torch.serve``).
"""

from repro_torch.serve.batcher import (Backpressure, MicroBatcher,
                                       ServeFuture, ServeRequest,
                                       ServerClosed)
from repro_torch.serve.cache import CacheStats, PredictionCache, ProgramCache
from repro_torch.serve.server import (EvaluateResult, PredictionServer,
                                      ServeClient, TuneResult)
from repro_torch.serve.tenants import (ModelSnapshot, TenantRegistry,
                                       UnknownFamilyError,
                                       UnknownTenantError)

__all__ = [
    "Backpressure",
    "ServerClosed",
    "MicroBatcher",
    "ServeFuture",
    "ServeRequest",
    "CacheStats",
    "PredictionCache",
    "ProgramCache",
    "EvaluateResult",
    "TuneResult",
    "PredictionServer",
    "ServeClient",
    "ModelSnapshot",
    "TenantRegistry",
    "UnknownFamilyError",
    "UnknownTenantError",
]
