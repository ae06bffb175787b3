"""Method registry — the single source of predictor names and construction.

The paper's method zoo (§III-B) as first-class, user-extensible
:class:`MethodSpec` records:

* **names** — the registry is the single source of display names
  (``MemoryPredictor.name`` resolves here via :func:`name_of`, including
  parameterized names like ``k-segments-selective`` / ``witt-p95``), with
  alias support (``witt`` → ``witt-p95``);
* **construction** — :func:`make` builds a method from a name and the
  per-family :class:`MethodContext` (segment count, machine memory, the
  family's default limit), so harness code never hardcodes constructors;
* **capability flags** — ``online`` (carries state worth feeding through
  ``observe``/``refit``), ``packed`` (vectorized ``predict_packed``),
  ``multi_segment`` (emits time-varying envelopes); the online replay
  harness and schedulers route on these instead of isinstance checks;
* **retry** — each spec pins the method's static :class:`RetrySpec`, so
  schedulers accept registry names anywhere they take retry rules;
* **offset auto-tuning** — :func:`tune_offset` picks the best
  :class:`OffsetCandidate` per task family from training replays, the way
  ``KSPlusAuto`` picks k (one batched fleet call over the whole candidate
  grid);
* **state carried across** — :func:`load_fitted` rebuilds a fitted method
  from plain numpy state (e.g. a reference-package fit), so prediction and
  replay can be checked against identical models.

Every method that computes on tensors takes ``device`` (None means the
card); :func:`make` resolves it once and hands it to the factory.

Registering a custom method::

    @register_method("my-method", retry=RetrySpec("double"), cls=MyMethod)
    def _make_my_method(ctx):
        return MyMethod(machine_memory=ctx.machine_memory)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.baselines import (
    DefaultMethod,
    KSegments,
    PPMImproved,
    TovarFeedback,
    TovarPPM,
    WittPercentile,
)
from repro_torch.core.envelope import OffsetCandidate, RetrySpec, apply_offsets
from repro_torch.core.ksplus import KSPlus, KSPlusAuto, MemoryPredictor
from repro_torch.core.predictor import LinReg, SegmentModel
from repro_torch.device import resolve_device

__all__ = [
    "MethodContext",
    "MethodSpec",
    "MissingCapabilityError",
    "register_method",
    "unregister_method",
    "get_spec",
    "canonical_name",
    "method_names",
    "name_of",
    "make",
    "resolve",
    "check_capabilities",
    "try_retry_spec",
    "DEFAULT_OFFSET_GRID",
    "tune_offset",
    "tune_offset_map",
    "load_fitted",
]


@dataclasses.dataclass(frozen=True)
class MethodContext:
    """Per-family construction context handed to method factories."""

    k: int = 4
    machine_memory: float = 128.0
    default_limit: float = 8.0
    device: object = None  # resolved torch.device (see :func:`make`)


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One registered prediction method.

    ``factory(ctx)`` builds a fresh instance; ``match`` narrows instance →
    spec resolution when several specs share a class (k-Segments variants);
    ``instance_name`` derives parameterized display names from an instance.
    """

    name: str
    cls: type
    factory: Callable[[MethodContext], MemoryPredictor]
    retry: RetrySpec
    online: bool = True
    packed: bool = True
    multi_segment: bool = False
    aliases: Tuple[str, ...] = ()
    match: Optional[Callable[[MemoryPredictor], bool]] = None
    instance_name: Optional[Callable[[MemoryPredictor], str]] = None


_SPECS: Dict[str, MethodSpec] = {}   # canonical name -> spec, insertion order
_ALIASES: Dict[str, str] = {}        # alias -> canonical name

# The flag names check_capabilities/make/resolve accept in ``require=``.
CAPABILITY_FLAGS: Tuple[str, ...] = ("online", "packed", "multi_segment")


class MissingCapabilityError(LookupError):
    """A resolve-time capability check failed.

    The caller asked for a path (``require=("packed",)``, ``("online",)``,
    ...) that the method's spec declares unsupported.  Raised by
    :func:`make` / :func:`resolve` / :func:`check_capabilities` so harness
    code fails loudly at construction instead of deep inside a batched
    replay.
    """

    def __init__(self, method: str, flag: str):
        super().__init__(
            f"method {method!r} does not support the {flag!r} path "
            f"(registered with {flag}=False)")
        self.method = method
        self.flag = flag


def register_method(name: str, *, retry: RetrySpec, cls: type,
                    online: bool = True, packed: bool = True,
                    multi_segment: bool = False,
                    aliases: Sequence[str] = (),
                    match: Optional[Callable] = None,
                    instance_name: Optional[Callable] = None):
    """Decorator: register ``factory`` as method ``name``.

    Raises on duplicate names/aliases — specs are global, collisions are
    always bugs.  Use :func:`unregister_method` to retract (tests, plugin
    teardown).
    """
    def deco(factory):
        spec = MethodSpec(
            name=name, cls=cls, factory=factory, retry=retry, online=online,
            packed=packed, multi_segment=multi_segment,
            aliases=tuple(aliases), match=match, instance_name=instance_name)
        taken = set(_SPECS) | set(_ALIASES)
        for n in (name, *spec.aliases):
            if n in taken:
                raise ValueError(f"method name already registered: {n!r}")
        _SPECS[name] = spec
        for a in spec.aliases:
            _ALIASES[a] = name
        return factory
    return deco


def unregister_method(name: str) -> None:
    spec = _SPECS.pop(canonical_name(name))
    for a in spec.aliases:
        _ALIASES.pop(a, None)


def canonical_name(name: str) -> str:
    """Resolve an alias to its canonical method name (identity otherwise)."""
    name = _ALIASES.get(name, name)
    if name not in _SPECS:
        raise KeyError(f"unknown method: {name!r} "
                       f"(registered: {', '.join(_SPECS)})")
    return name


def get_spec(name: str) -> MethodSpec:
    return _SPECS[canonical_name(name)]


def method_names() -> List[str]:
    """Canonical names in registration order — the default method zoo."""
    return list(_SPECS)


def make(name: str, *, k: int = 4, machine_memory: float = 128.0,
         default_limit: float = 8.0,
         require: Sequence[str] = (), device=None) -> MemoryPredictor:
    """Construct a fresh method instance from its registry name.

    ``require`` names capability flags the caller's code path depends on
    (``"online"``, ``"packed"``, ``"multi_segment"``); a spec registered
    with any of them False raises :class:`MissingCapabilityError` here,
    at resolve time, with the method and flag named.  ``device`` is where
    the method fits (None means the card; without CUDA that raises).
    """
    spec = get_spec(name)
    _check_spec(spec, require)
    ctx = MethodContext(k=k, machine_memory=machine_memory,
                        default_limit=default_limit,
                        device=resolve_device(device))
    return spec.factory(ctx)


def resolve(method: Union[str, MemoryPredictor], *,
            require: Sequence[str] = (), **ctx) -> MemoryPredictor:
    """A method instance from a registry name (constructed) or pass-through.

    Capability validation (``require=``, see :func:`make`) applies to both
    forms: instances resolve back to their spec via the same exact-type +
    ``match`` rules as :func:`name_of`.
    """
    if isinstance(method, str):
        return make(method, require=require, **ctx)
    check_capabilities(method, require=require)
    return method


def _spec_of_instance(method: MemoryPredictor) -> Optional[MethodSpec]:
    """The spec an instance resolves to (``name_of``'s matching rules),
    or None for unregistered classes."""
    cls_specs = [s for s in _SPECS.values() if type(method) is s.cls]
    for spec in cls_specs:
        if spec.match is None or spec.match(method):
            return spec
    return cls_specs[0] if cls_specs else None


def _check_spec(spec: MethodSpec, require: Sequence[str]) -> None:
    for flag in require:
        if flag not in CAPABILITY_FLAGS:
            raise ValueError(
                f"unknown capability flag {flag!r} "
                f"(valid: {', '.join(CAPABILITY_FLAGS)})")
        if not getattr(spec, flag):
            raise MissingCapabilityError(spec.name, flag)


def check_capabilities(method: Union[str, MemoryPredictor],
                       require: Sequence[str] = ()) -> None:
    """Raise :class:`MissingCapabilityError` unless ``method`` carries
    every flag in ``require``.

    Accepts a registry name or an instance.  An instance of an
    *unregistered* class has no spec to consult; the one structurally
    visible capability (``packed`` ⇔ ``predict_packed`` exists) is still
    validated, the rest pass (custom methods opt into flags by
    registering).
    """
    if isinstance(method, str):
        _check_spec(get_spec(method), require)
        return
    spec = _spec_of_instance(method)
    if spec is not None:
        _check_spec(spec, require)
        return
    for flag in require:
        if flag not in CAPABILITY_FLAGS:
            raise ValueError(
                f"unknown capability flag {flag!r} "
                f"(valid: {', '.join(CAPABILITY_FLAGS)})")
        if flag == "packed" and not hasattr(method, "predict_packed"):
            raise MissingCapabilityError(name_of(method), flag)


def name_of(method: MemoryPredictor) -> str:
    """Display name of an instance — the registry is the single source.

    Exact-type specs win (with their ``match`` predicate, so k-Segments
    variants resolve to distinct names); an unregistered subclass falls
    back to its lowercased class name.
    """
    cls_specs = [s for s in _SPECS.values() if type(method) is s.cls]
    for spec in cls_specs:
        if spec.match is None or spec.match(method):
            return spec.instance_name(method) if spec.instance_name \
                else spec.name
    for spec in cls_specs:  # registered class, unmatched parameterization
        if spec.instance_name is not None:
            return spec.instance_name(method)
    return type(method).__name__.lower()


def try_retry_spec(name: str) -> Optional[RetrySpec]:
    """The registered method's retry rule, or None for unknown names (the
    schedulers then fall back to interpreting ``name`` as a RetrySpec
    kind)."""
    try:
        return get_spec(name).retry
    except KeyError:
        return None


# ------------------------------------------------------- the built-in zoo
@register_method("ks+", retry=RetrySpec("ksplus"), cls=KSPlus,
                 aliases=("ksplus", "ks-plus"), multi_segment=True)
def _make_ksplus(ctx: MethodContext) -> KSPlus:
    return KSPlus(k=ctx.k, device=ctx.device)


@register_method("ks+auto", retry=RetrySpec("ksplus"), cls=KSPlusAuto,
                 aliases=("ksplus-auto",), multi_segment=True)
def _make_ksplus_auto(ctx: MethodContext) -> KSPlusAuto:
    return KSPlusAuto(machine_memory=ctx.machine_memory,
                      device=ctx.device)


@register_method("k-segments-selective",
                 retry=RetrySpec("kseg-selective", margin=0.10),
                 cls=KSegments, aliases=("kseg-selective",),
                 multi_segment=True,
                 match=lambda m: m.variant == "selective",
                 instance_name=lambda m: f"k-segments-{m.variant}")
def _make_kseg_selective(ctx: MethodContext) -> KSegments:
    return KSegments(k=ctx.k, variant="selective", device=ctx.device)


@register_method("k-segments-partial",
                 retry=RetrySpec("kseg-partial", margin=0.10),
                 cls=KSegments, aliases=("kseg-partial",),
                 multi_segment=True,
                 match=lambda m: m.variant == "partial",
                 instance_name=lambda m: f"k-segments-{m.variant}")
def _make_kseg_partial(ctx: MethodContext) -> KSegments:
    return KSegments(k=ctx.k, variant="partial", device=ctx.device)


@register_method("tovar-ppm", retry=RetrySpec("max-machine"), cls=TovarPPM,
                 aliases=("tovar",), online=False)
def _make_tovar(ctx: MethodContext) -> TovarPPM:
    # online=False: the paper's fit-once baseline stays frozen even in
    # online replays — tovar-feedback is the feedback-loop variant.
    return TovarPPM(machine_memory=ctx.machine_memory)


@register_method("tovar-feedback", retry=RetrySpec("max-machine"),
                 cls=TovarFeedback)
def _make_tovar_feedback(ctx: MethodContext) -> TovarFeedback:
    return TovarFeedback(machine_memory=ctx.machine_memory)


@register_method("ppm-improved", retry=RetrySpec("double"), cls=PPMImproved,
                 aliases=("ppm",))
def _make_ppm_improved(ctx: MethodContext) -> PPMImproved:
    return PPMImproved(machine_memory=ctx.machine_memory)


@register_method("witt-p95", retry=RetrySpec("double"), cls=WittPercentile,
                 aliases=("witt",),
                 match=lambda m: round(m.percentile) == 95,
                 instance_name=lambda m: f"witt-p{int(round(m.percentile))}")
def _make_witt(ctx: MethodContext) -> WittPercentile:
    return WittPercentile(percentile=95.0,
                          machine_memory=ctx.machine_memory)


@register_method("default", retry=RetrySpec("double"), cls=DefaultMethod,
                 aliases=("static-default",), online=False)
def _make_default(ctx: MethodContext) -> DefaultMethod:
    # online=False: a static limit has no state to update.
    return DefaultMethod(limit_gb=ctx.default_limit,
                         machine_memory=ctx.machine_memory)


# -------------------------------------------------- offset auto-tuning hook
DEFAULT_OFFSET_GRID: Tuple[OffsetCandidate, ...] = (
    OffsetCandidate(),                       # identity = the plan's own ±10/15%
    OffsetCandidate(peak=0.10),
    OffsetCandidate(peak=-0.05),
    OffsetCandidate(start=0.10),
    OffsetCandidate(peak=0.05, start=0.05),
    OffsetCandidate(peak=0.10, last_peak_bump=0.50),
)


def tune_offset(method: Union[str, MemoryPredictor],
                mems: Sequence[np.ndarray], dts: Sequence[float],
                inputs: Sequence[float], *,
                candidates: Optional[Sequence[OffsetCandidate]] = None,
                machine_memory: float = 128.0, device=None
                ) -> Tuple[OffsetCandidate, np.ndarray]:
    """Pick the best safety-offset candidate for one task family.

    The way :class:`KSPlusAuto` picks k: replay the *training* executions
    through the OOM/retry fleet engine once per candidate — all candidates
    share the device-resident trace batch (on ``device``; None means the
    card) and go out as one
    :func:`repro_torch.core.fleet.simulate_fleet_many` call (per-candidate retry
    specs, e.g. a swept ``last_peak_bump``, ride along) — and keep the
    candidate with the lowest training wastage.

    ``method`` (a fitted instance or a registry name of a fit-free method)
    must already be fitted on ``mems``/``dts``/``inputs``.  Requires a
    uniform ``dt`` (the fleet lane batch shares one sampling period).

    Returns ``(best_candidate, per_candidate_total_gbs)``.
    """
    from repro_torch.core.fleet import packed_predict, simulate_fleet_many

    method = resolve(method, machine_memory=machine_memory, device=device)
    cands = tuple(candidates if candidates is not None
                  else DEFAULT_OFFSET_GRID)
    if not cands:
        raise ValueError("need at least one OffsetCandidate")
    if len(set(float(d) for d in dts)) != 1:
        raise ValueError("tune_offset needs a uniform dt across executions")
    starts, peaks, nseg = packed_predict(method, list(inputs))
    jobs = []
    for cand in cands:
        st, pk = apply_offsets(starts, peaks, nseg, cand)
        spec = method.retry_spec
        if cand.last_peak_bump is not None:
            spec = spec._replace(bump=cand.last_peak_bump)
        jobs.append(((st.astype(np.float32), pk.astype(np.float32), nseg),
                     spec))
    results = simulate_fleet_many(jobs, list(mems), float(dts[0]),
                                  machine_memory=machine_memory,
                                  device=device)
    totals = np.asarray([r.total_gbs for r in results])
    return cands[int(np.argmin(totals))], totals


def tune_offset_map(fitted: Dict[str, Union[str, MemoryPredictor]],
                    data: Dict[str, Tuple[Sequence[np.ndarray],
                                          Sequence[float],
                                          Sequence[float]]], *,
                    candidates: Optional[Sequence[OffsetCandidate]] = None,
                    machine_memory: float = 128.0, device=None
                    ) -> Dict[str, OffsetCandidate]:
    """Per-family :func:`tune_offset` winners.

    ``fitted`` maps family -> fitted method (or fit-free registry name),
    ``data`` maps family -> ``(mems, dts, inputs)`` training executions.
    Winners may disagree on every field *including* ``last_peak_bump``,
    which a packed replay folds into a per-lane bump array
    (:func:`repro_torch.core.envelope.retry_packed`, the fleet engine's
    ``bump_lanes``).
    """
    out: Dict[str, OffsetCandidate] = {}
    for fam, method in fitted.items():
        mems, dts, inputs = data[fam]
        out[fam], _ = tune_offset(
            method, mems, dts, inputs, candidates=candidates,
            machine_memory=machine_memory, device=device)
    return out


# ------------------------------------------------------- state carried across
def _segment_model(st: dict, peak_offset: float,
                   start_offset: float) -> SegmentModel:
    arr = np.asarray
    return SegmentModel(
        k=int(st["k"]),
        start_reg=LinReg(arr(st["start_slope"]), arr(st["start_intercept"])),
        peak_reg=LinReg(arr(st["peak_slope"]), arr(st["peak_intercept"])),
        runtime_reg=LinReg(arr(st["runtime_slope"]),
                           arr(st["runtime_intercept"])),
        peak_offset=peak_offset, start_offset=start_offset)


def _rows(st: dict):
    rows = st.get("rows")
    return None if rows is None else tuple(np.asarray(r) for r in rows)


def _load_ksplus(m: KSPlus, st: dict) -> None:
    m._model = _segment_model(st["model"], m.peak_offset, m.start_offset)
    m._rows = _rows(st)


def _load_auto(m: KSPlusAuto, st: dict) -> None:
    m.chosen_k = int(st["chosen_k"])
    m._model = KSPlus(k=m.chosen_k, peak_offset=m.peak_offset,
                      start_offset=m.start_offset,
                      last_peak_bump=m.last_peak_bump, device=m.device)
    _load_ksplus(m._model, st["model"])


def _load_ksegments(m: KSegments, st: dict) -> None:
    arr = np.asarray
    m._runtime_reg = LinReg(arr(st["runtime_slope"]),
                            arr(st["runtime_intercept"]))
    m._peak_reg = LinReg(arr(st["peak_slope"]), arr(st["peak_intercept"]))
    m._rows = _rows(st)


def _load_first_alloc(m, st: dict) -> None:
    m._first_alloc = float(st["first_alloc"])


def _load_tovar_feedback(m: TovarFeedback, st: dict) -> None:
    m._peaks = [float(p) for p in st["peaks"]]
    m._runtimes = [float(r) for r in st["runtimes"]]
    m._first_alloc = float(st["first_alloc"])


def _load_ppm_improved(m: PPMImproved, st: dict) -> None:
    m._inner = TovarPPM(machine_memory=m.machine_memory)
    _load_first_alloc(m._inner, st)


_LOADERS = {
    KSPlus: _load_ksplus,
    KSPlusAuto: _load_auto,
    KSegments: _load_ksegments,
    TovarPPM: _load_first_alloc,
    WittPercentile: _load_first_alloc,
    TovarFeedback: _load_tovar_feedback,
    PPMImproved: _load_ppm_improved,
    DefaultMethod: lambda m, st: None,  # nothing fitted
}


def load_fitted(name: str, state: dict, **ctor) -> MemoryPredictor:
    """A fitted method of registry ``name`` rebuilt from plain state.

    ``ctor`` holds constructor fields (``k``, ``machine_memory``,
    ``limit_gb``, ``device``, offsets, ...) applied over the registry's
    defaults.  ``state`` is numpy, per class:

    * ``ks+``: ``{"model": {"k", "start_slope", "start_intercept",
      "peak_slope", "peak_intercept", "runtime_slope",
      "runtime_intercept"}, "rows": (starts_sec, peaks, runtimes, inputs)
      or None}`` — the SegmentModel and the cached segmentation rows;
    * ``ks+auto``: ``{"chosen_k", "model": <ks+ state>}``;
    * ``k-segments-*``: ``{"runtime_slope", "runtime_intercept",
      "peak_slope", "peak_intercept", "rows": (runtimes, peaks, inputs)
      or None}``;
    * ``tovar-ppm``, ``ppm-improved``, ``witt-p95``: ``{"first_alloc"}``;
    * ``tovar-feedback``: ``{"first_alloc", "peaks", "runtimes"}``;
    * ``default``: ``{}``.
    """
    spec = get_spec(name)
    method = make(spec.name, device=ctor.pop("device", None))
    if ctor:
        method = dataclasses.replace(method, **ctor)
    if spec.match is not None and not spec.match(method):
        raise ValueError(f"constructor fields {ctor} do not match {name!r}")
    _LOADERS[spec.cls](method, state)
    return method
