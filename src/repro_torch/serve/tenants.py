"""Per-tenant fitted-model state with copy-on-refit snapshot sharing.

Many tenants serving the same task family usually start from the same
fitted model (the operator seeds one fit per family and shares it).
Snapshots make that cheap and safe:

* a :class:`ModelSnapshot` is **frozen**: once published it is never
  mutated — every reader (predict dispatch, caches, in-flight batches)
  can hold it without locks;
* ``observe`` appends to *tenant-local* pending state only (one small
  per-tenant lock); the shared snapshot is untouched, so one tenant's
  feedback never perturbs another tenant's predictions;
* ``refit`` is **copy-on-refit**: when a tenant's :class:`RefitPolicy`
  comes due, the snapshot's method is deep-copied *off to the side*, the
  tenant's pending outcomes are replayed into the clone (the methods'
  own incremental-refit machinery — segmentation-tail caches etc. —
  rides along), and only then is the tenant's pointer swapped to a new
  snapshot with a bumped ``version``.  Other tenants keep the old
  snapshot; a reader that raced the swap sees a consistent (old) model.

Snapshot identity (``sid``) is process-unique and is the cache
generation: :mod:`repro_torch.serve.cache` keys prediction entries and
device-resident trace batches by it, so a refit invalidates exactly the
forked tenant's entries and nothing else.

The registry holds its server's device: every seeded method fits there
(None means the card), and the snapshots' trace batches are built there.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

import torch

from repro_torch.core import registry
from repro_torch.core.predictor import (ExecutionOutcome, MemoryPredictor,
                                        RefitPolicy)
from repro_torch.device import resolve_device

__all__ = [
    "UnknownTenantError",
    "UnknownFamilyError",
    "ModelSnapshot",
    "TenantRegistry",
]

_SID = itertools.count(1)


class UnknownTenantError(KeyError):
    """The named tenant was never created on this server."""


class UnknownFamilyError(KeyError):
    """The tenant has no fitted model for the named task family."""


@dataclasses.dataclass(frozen=True)
class ModelSnapshot:
    """One published, immutable fitted model (+ its training data).

    ``sid`` is globally unique across all snapshots; ``version`` counts
    refits along one tenant's lineage (the seed is version 0).  The
    training arrays ride along so ``tune_offset`` / ``evaluate``
    dispatches replay the exact data the model was fitted on.
    """

    method: MemoryPredictor
    method_name: str
    family: str
    version: int
    sid: int
    dt: float
    machine_memory: float
    train_mems: Tuple[np.ndarray, ...]
    train_dts: Tuple[float, ...]
    train_inputs: Tuple[float, ...]

    def fork(self, method: MemoryPredictor,
             extra: Sequence[ExecutionOutcome]) -> "ModelSnapshot":
        """A refitted successor: version+1, fresh sid, history extended
        by the outcomes that drove the refit."""
        return dataclasses.replace(
            self, method=method, version=self.version + 1, sid=next(_SID),
            train_mems=self.train_mems + tuple(
                np.asarray(o.mem) for o in extra),
            train_dts=self.train_dts + tuple(float(o.dt) for o in extra),
            train_inputs=self.train_inputs + tuple(
                float(o.input_gb) for o in extra))


class _TenantState:
    """One tenant: snapshot pointers + pending (not-yet-refitted) outcomes."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()   # guards writes; reads are lock-free
        self.families: Dict[str, ModelSnapshot] = {}
        self.pending: Dict[str, List[ExecutionOutcome]] = {}
        self.failures: Dict[str, int] = {}
        self.refits = 0


class TenantRegistry:
    """All tenants of one :class:`repro_torch.serve.PredictionServer`, on
    its ``device`` (None means the card; without CUDA that raises)."""

    def __init__(self, *, machine_memory: float = 128.0, device=None):
        self.machine_memory = float(machine_memory)
        self.device: torch.device = resolve_device(device)
        self._tenants: Dict[str, _TenantState] = {}
        self._lock = threading.Lock()
        # Refit listeners (the server hooks cache invalidation in here).
        self._on_refit = []

    # ------------------------------------------------------------ tenants
    def add_tenant(self, name: str) -> None:
        with self._lock:
            if name in self._tenants:
                raise ValueError(f"tenant already exists: {name!r}")
            self._tenants[name] = _TenantState(name)

    def tenant_names(self) -> List[str]:
        return list(self._tenants)

    def _state(self, tenant: str) -> _TenantState:
        try:
            return self._tenants[tenant]
        except KeyError:
            raise UnknownTenantError(
                f"unknown tenant: {tenant!r} "
                f"(known: {', '.join(self._tenants) or 'none'})") from None

    def on_refit(self, fn) -> None:
        """Register ``fn(tenant, family, old_snapshot, new_snapshot)`` to
        run after every published refit (cache invalidation hook)."""
        self._on_refit.append(fn)

    # ------------------------------------------------------------ seeding
    def seed(self, family: str, method: Union[str, MemoryPredictor],
             mems: Sequence[np.ndarray], dts: Sequence[float],
             inputs: Sequence[float], *, k: int = 4,
             default_limit: float = 8.0,
             tenants: Optional[Sequence[str]] = None) -> ModelSnapshot:
        """Fit ``method`` once on the family's training executions and
        share the frozen snapshot across ``tenants`` (default: all).

        ``method`` resolves through :mod:`repro_torch.core.registry` (a
        name is constructed on the registry's device) and must carry the
        ``packed`` capability — the batched dispatch path is
        built on ``predict_packed`` (`require=("packed",)` raises the
        registry's named :class:`~repro_torch.core.registry.MissingCapabilityError`
        otherwise, at seed time rather than deep inside a flush).
        """
        if len(set(float(d) for d in dts)) != 1:
            raise ValueError(
                f"serve family {family!r} needs a uniform training dt "
                "(the batched evaluate/tune dispatches share one sampling "
                "period per family)")
        inst = registry.resolve(method, k=k,
                                machine_memory=self.machine_memory,
                                default_limit=default_limit,
                                require=("packed",), device=self.device)
        inst.fit(list(mems), list(dts), list(inputs))
        snap = ModelSnapshot(
            method=inst, method_name=registry.name_of(inst), family=family,
            version=0, sid=next(_SID), dt=float(dts[0]),
            machine_memory=self.machine_memory,
            train_mems=tuple(np.asarray(m) for m in mems),
            train_dts=tuple(float(d) for d in dts),
            train_inputs=tuple(float(i) for i in inputs))
        names = self.tenant_names() if tenants is None else tenants
        for t in names:
            st = self._state(t)
            with st.lock:
                st.families[family] = snap
                st.pending[family] = []
                st.failures[family] = 0
        return snap

    # ------------------------------------------------------------- reads
    def snapshot(self, tenant: str, family: str) -> ModelSnapshot:
        """The tenant's current snapshot — a lock-free pointer read (the
        dict value is swapped atomically by refit, never mutated)."""
        st = self._state(tenant)
        try:
            return st.families[family]
        except KeyError:
            raise UnknownFamilyError(
                f"tenant {tenant!r} has no fitted family {family!r} "
                f"(fitted: {', '.join(st.families) or 'none'})") from None

    def families(self, tenant: str) -> List[str]:
        return list(self._state(tenant).families)

    def evaluate_data(self, tenant: str, family: str):
        """``(mems, dts, inputs)`` the tenant's ``evaluate`` replays: the
        snapshot's fitted history plus any still-pending observations."""
        st = self._state(tenant)
        snap = self.snapshot(tenant, family)
        with st.lock:
            pend = list(st.pending.get(family, ()))
        return (list(snap.train_mems) + [np.asarray(o.mem) for o in pend],
                list(snap.train_dts) + [float(o.dt) for o in pend],
                list(snap.train_inputs) + [float(o.input_gb) for o in pend])

    # ------------------------------------------------------------- writes
    def observe(self, tenant: str, family: str,
                outcome: ExecutionOutcome) -> int:
        """Append one finished execution to the tenant's pending state.

        Touches only tenant-local lists under the tenant's own lock — the
        shared snapshot (and with it every other tenant's reads) is
        untouched.  Returns the pending count.
        """
        st = self._state(tenant)
        self.snapshot(tenant, family)  # loud on unknown family
        with st.lock:
            st.pending[family].append(outcome)
            if outcome.oomed:
                st.failures[family] += 1
            return len(st.pending[family])

    def refit(self, tenant: str, family: str,
              policy: Union[RefitPolicy, str] = "every_1") -> bool:
        """Copy-on-refit: maybe fork the tenant's snapshot for ``family``.

        Evaluates ``policy`` against the tenant's pending outcomes; when
        due, clones the (possibly shared) method, replays the pending
        outcomes through the clone's own ``observe``/``refit`` lifecycle
        (incremental refits included), publishes the fork as a new
        snapshot and clears the pending state.  Other tenants sharing the
        old snapshot are unaffected.  Returns True iff a refit happened.

        Raises the registry's named capability error for methods
        registered with ``online=False`` — a frozen baseline has no
        online state to refit.
        """
        st = self._state(tenant)
        old = self.snapshot(tenant, family)
        registry.check_capabilities(old.method, require=("online",))
        pol = RefitPolicy.parse(policy)
        with st.lock:
            pend = list(st.pending[family])
            fails = st.failures[family]
        if not pol.due(len(pend), fails):
            return False
        # The expensive part — clone + replay + refit — runs outside the
        # tenant lock: concurrent reads (and other tenants) never wait on it.
        clone = copy.deepcopy(old.method)
        for o in pend:
            clone.observe(o)
        clone.refit(RefitPolicy("every_n", 1))
        new = old.fork(clone, pend)
        with st.lock:
            st.families[family] = new
            # Keep observations that raced in during the refit pending.
            st.pending[family] = st.pending[family][len(pend):]
            st.failures[family] = sum(
                1 for o in st.pending[family] if o.oomed)
            st.refits += 1
        for fn in self._on_refit:
            fn(tenant, family, old, new)
        return True
