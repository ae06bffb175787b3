"""Serving caches: packed predictions + dispatch-shape/trace residency.

Two caches with one discipline — every entry is keyed by the *snapshot
id* of the model that produced it, so invalidation is **refit-scoped**:
when a tenant forks its snapshot (:mod:`repro_torch.serve.tenants`), its
lookups move to the new sid (which misses naturally) while every tenant
still sharing the old snapshot keeps its warm entries; the old sid's
entries are dropped only once no tenant references it.  Snapshots are
immutable, so an entry keyed by a still-live sid can never go stale.

* :class:`PredictionCache` — memoizes packed plan rows per
  ``(sid, input_gb)``.  Production prediction traffic is heavily
  repeated (workflow engines resubmit the same task sizes all day), so
  hits resolve at *submit* time — no batch wait, no dispatch — and fire
  the ``serve.cache_hit`` dispatch tag for budget enforcement.  Bounded
  FIFO (oldest-inserted evicts first).

* :class:`ProgramCache` — two residency registries for the batched
  dispatch path:

  - **shapes**: the ``(method, family, k, dt, bucket_shape)`` keys of
    every batched dispatch this server has made, with exact lane counts
    (nothing is padded).  A record for dashboards only: eager PyTorch
    compiles nothing per shape, so ``distinct_shapes`` bounds no compile
    and is not comparable with a padded server's count.  The serving
    path's "never compiles" contract is held by ``dispatch_budget(
    compiles=0)``, which counts the kernel builds and library loads of
    :mod:`repro_torch.kernels.build`.
  - **traces**: device-resident :class:`repro_torch.core.fleet.FleetBatch`
    uploads per snapshot, built once per ``(tenant, family, sid)`` on the
    server's device — the ``serve.dev_sync`` tag fires only on the build,
    so repeated ``evaluate`` / ``tune_offset`` calls against an unchanged
    model re-use the uploaded traces instead of re-staging host memory.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from repro_torch.analysis.contracts import record_dispatch

__all__ = ["CacheStats", "PredictionCache", "ProgramCache"]


@dataclasses.dataclass
class CacheStats:
    """Hit/miss/invalidation counters (``hit_rate`` for dashboards)."""

    hits: int = 0
    misses: int = 0
    invalidations: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses,
                "invalidations": self.invalidations,
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}


class PredictionCache:
    """Packed plan rows keyed by ``(sid, input_gb)``.

    The snapshot id already encodes tenant lineage and refit version, so
    two tenants sharing a seed snapshot *share hits* until one of them
    refits — copy-on-refit for cache entries, mirroring the model state.
    """

    def __init__(self, max_entries: int = 65536):
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._by_sid: Dict[int, set] = {}
        self.stats = CacheStats()

    def get(self, sid: int, input_gb: float) -> Optional[tuple]:
        key = (sid, float(input_gb))
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.stats.misses += 1
                return None
            self.stats.hits += 1
        record_dispatch("serve.cache_hit")
        return hit

    def put(self, sid: int, input_gb: float, plan_row: tuple) -> None:
        key = (sid, float(input_gb))
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = plan_row
            self._by_sid.setdefault(sid, set()).add(key)
            while len(self._entries) > self.max_entries:
                old, _ = self._entries.popitem(last=False)
                self._by_sid.get(old[0], set()).discard(old)
                self.stats.evictions += 1

    def invalidate_sid(self, sid: int) -> int:
        """Drop every entry produced by snapshot ``sid`` (refit scope)."""
        with self._lock:
            keys = self._by_sid.pop(sid, set())
            for k in keys:
                self._entries.pop(k, None)
            self.stats.invalidations += len(keys)
            return len(keys)

    def __len__(self) -> int:
        return len(self._entries)


class ProgramCache:
    """Dispatched-shape registry + per-snapshot device trace residency."""

    def __init__(self):
        self._lock = threading.Lock()
        self._shapes: Dict[tuple, int] = {}
        self._traces: Dict[Tuple[str, str, int], object] = {}
        self.shape_stats = CacheStats()
        self.trace_stats = CacheStats()

    # ------------------------------------------------------------- shapes
    def note_shape(self, method: str, family: Optional[str], k: int,
                   dt: Optional[float], bucket_shape: tuple) -> bool:
        """Record one batched-dispatch key; True iff it was seen before.

        ``family`` is None for cross-family gathered predict buckets (the
        program is shared by construction); ``dt`` is None for predict
        (no time axis in plan evaluation).
        """
        key = (method, family, int(k), dt if dt is None else float(dt),
               tuple(bucket_shape))
        with self._lock:
            warm = key in self._shapes
            self._shapes[key] = self._shapes.get(key, 0) + 1
            if warm:
                self.shape_stats.hits += 1
            else:
                self.shape_stats.misses += 1
        return warm

    @property
    def distinct_shapes(self) -> int:
        """Distinct dispatch keys so far: exact lane counts, so it grows
        with traffic and bounds no compile (see the module docstring)."""
        return len(self._shapes)

    # ------------------------------------------------------------- traces
    def trace_batch(self, tenant: str, family: str, sid: int,
                    build: Callable[[], object]):
        """The snapshot's device-resident trace batch, built at most once.

        The build (host packing + device upload) fires ``serve.dev_sync``;
        hits return the resident object without touching the device.
        """
        key = (tenant, family, sid)
        with self._lock:
            got = self._traces.get(key)
        if got is not None:
            self.trace_stats.hits += 1
            return got
        batch = build()  # outside the lock: uploads are slow
        record_dispatch("serve.dev_sync")
        with self._lock:
            self._traces.setdefault(key, batch)
            self.trace_stats.misses += 1
            return self._traces[key]

    def invalidate_tenant_family(self, tenant: str, family: str) -> int:
        """Drop the tenant+family's resident traces (refit scope)."""
        with self._lock:
            dead = [k for k in self._traces
                    if k[0] == tenant and k[1] == family]
            for k in dead:
                del self._traces[k]
            self.trace_stats.invalidations += len(dead)
            return len(dead)
