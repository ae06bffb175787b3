"""Trace-driven evaluation harness (paper §III) + online replay.

Fits every method per task family on the training split, replays the test
split through the OOM/retry simulator, and aggregates GB·s wastage —
reproducing the comparisons behind Figs. 6–8.

The replay runs on the batched fleet engine (:mod:`repro_torch.core.fleet`)
by default: the entire workflow's test split becomes one ``(B, T)`` lane
batch per method on ``device`` (None means the card, where every attempt
of every lane goes through the CUDA ``oom_probe`` kernel), instead of
``families × executions × attempts`` Python-level numpy calls.
``engine="oracle"`` keeps the original per-execution loop — it is the
ground truth the engine is differentially tested against.

``mode="online"`` streams the test split *in submission order* through the
predictor lifecycle (:class:`repro_torch.core.predictor.MemoryPredictor`):
executions are grouped into rounds (the i-th ``round_size`` executions of
every family share an event time), each round replays as one compacted
fleet call over a lane *subset* of the shared trace batch
(:func:`repro_torch.core.fleet.subset_batch` — bucket widths are preserved, so
per-lane arithmetic stays bit-identical to the offline batch), and between
rounds every online-capable method ``observe``s its outcomes and ``refit``s
under the given policy — one compacted refit per (family, method) per event
time, mirroring the cluster engine's event-batched retries.  With
``refit="never"`` no model ever changes, so online replay reproduces the
offline :class:`ExperimentResult` bitwise.

Workflows come from :mod:`repro_torch.traces.generator`; scenario names and
``WorkflowTrace`` inputs (the reference's ``repro.workloads``) are not
carried over yet and raise :class:`NotImplementedError`.

The method zoo lives in :mod:`repro_torch.core.registry` — method *names*
(including aliases) are accepted everywhere method lists are, and each
family's methods are constructed from the registry with the family's real
``default_limit_gb``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np

from repro_torch.core import (
    ExecutionOutcome,
    RefitPolicy,
    bucket_traces,
    concat_packed,
    packed_predict,
    refit_batched,
    registry,
    simulate_execution,
    simulate_fleet_many,
    subset_batch,
)
from repro_torch.core.fleet import PAD_START, FleetResult
from repro_torch.device import resolve_device
from repro_torch.traces.generator import Workflow

__all__ = ["MethodResult", "ExperimentResult", "evaluate_workflow",
           "run_paper_experiment"]


@dataclasses.dataclass
class MethodResult:
    name: str
    per_family_gbs: Dict[str, float]
    total_gbs: float
    retries: int
    failures: int  # executions that never succeeded (hit machine limits)


@dataclasses.dataclass
class ExperimentResult:
    workflow: str
    seed: int
    train_frac: float
    methods: Dict[str, MethodResult]
    # Wall seconds per stage ("fit", "predict", "replay"; online and oracle
    # runs interleave predict with replay and report both as "replay").
    # Each stage ends in a host read, so on the card the times include the
    # device work.
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict,
                                                  compare=False)
    # The fitted methods, family -> method name -> instance (inspection:
    # e.g. the k that ks+auto chose per family).
    fitted: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def reduction_vs(self, method: str, baseline: str) -> float:
        """Fractional wastage reduction of ``method`` vs ``baseline``."""
        b = self.methods[baseline].total_gbs
        m = self.methods[method].total_gbs
        return (b - m) / b if b > 0 else 0.0


def _fit_methods(wf: Workflow, train, names, k, machine_memory, device):
    """Construct (from the registry, with each family's real default
    limit) and fit every method on every family's training split."""
    fitted: Dict[str, Dict[str, object]] = {}
    for fname, train_execs in train.items():
        fam = wf.families[fname]
        mems = [e.mem for e in train_execs]
        dts = [e.dt for e in train_execs]
        inputs = [e.input_gb for e in train_execs]
        fitted[fname] = {}
        for mname in names:
            method = registry.make(mname, k=k, machine_memory=machine_memory,
                                   default_limit=fam.default_limit_gb,
                                   device=device)
            method.fit(mems, dts, inputs)
            fitted[fname][mname] = method
    return fitted


def _method_jobs(fitted, train, test, names):
    """One packed-plan job per method over the whole flat test split,
    family-major — the offline fleet batch."""
    jobs = []
    for mname in names:
        parts = [
            packed_predict(fitted[fname][mname],
                           [e.input_gb for e in test[fname]])
            for fname in train if test[fname]
        ]
        specs = {fitted[fname][mname].retry_spec for fname in train}
        assert len(specs) == 1, f"{mname}: retry spec differs across families"
        jobs.append((concat_packed(parts), specs.pop()))
    return jobs


def _aggregate_fleet(results, fleet, names, train, fam_idx):
    """Fold per-lane fleet outcomes into MethodResults (shared by the
    offline and online paths — identical reduction order, so the online
    ``refit="never"`` replay matches offline bitwise)."""
    for mname, fr in zip(names, fleet):
        per_fam = np.zeros(len(train))
        np.add.at(per_fam, fam_idx, fr.wastage_gbs)
        for i, fname in enumerate(train):
            results[mname].per_family_gbs[fname] = float(per_fam[i])
        results[mname].total_gbs = float(fr.wastage_gbs.sum())
        results[mname].retries = int(fr.retries.sum())
        results[mname].failures = int((~fr.succeeded).sum())


def _as_workflow(wf) -> Workflow:
    if isinstance(wf, str) or hasattr(wf, "to_workflow"):
        raise NotImplementedError(
            "scenario names and WorkflowTrace inputs need the workloads "
            "package, not ported yet (ROADMAP A7); pass a "
            "repro_torch.traces.generator.Workflow")
    return wf


def evaluate_workflow(
    wf: Workflow,
    *,
    seed: int,
    train_frac: float,
    k: int = 4,
    machine_memory: float = 128.0,
    methods: Optional[List[str]] = None,
    dt: float = 1.0,
    engine: str = "fleet",
    mode: str = "offline",
    refit: Union[RefitPolicy, str] = "never",
    round_size: int = 1,
    device=None,
) -> ExperimentResult:
    """Fit + replay one (workflow, seed, train fraction) cell.

    ``wf`` is a :class:`repro_torch.traces.generator.Workflow` (scenario
    names and ``WorkflowTrace`` inputs raise ``NotImplementedError`` until
    the workloads package is ported).  ``device`` is where fitting and the
    fleet replay run: None means the card, and without CUDA that raises.

    ``engine="fleet"`` (default) runs the replay on the batched engine —
    every method over the *whole* test split, sharing one trace batch;
    ``engine="oracle"`` replays execution-by-execution through
    :func:`simulate_execution`.

    ``mode="online"`` (fleet engine only) streams the test split through
    the predictor lifecycle: per round of ``round_size`` executions per
    family, replay → ``observe`` → ``refit(refit)``.  Methods whose
    registry spec says ``online=False`` (the frozen paper baselines) replay
    with their fit-once models.  ``refit="never"`` reproduces the offline
    result bitwise.
    """
    wf = _as_workflow(wf)
    dev = resolve_device(device)
    if engine not in ("fleet", "oracle"):
        raise ValueError(f"unknown engine: {engine!r}")
    if mode not in ("offline", "online"):
        raise ValueError(f"unknown mode: {mode!r}")
    if mode == "online" and engine != "fleet":
        raise ValueError("mode='online' requires engine='fleet'")
    if round_size < 1:
        raise ValueError(f"round_size must be >= 1, got {round_size}")
    policy = RefitPolicy.parse(refit)
    train, test = wf.split(seed, train_frac, dt)
    names = [registry.canonical_name(m) for m in methods] if methods \
        else registry.method_names()
    results: Dict[str, MethodResult] = {
        m: MethodResult(m, {}, 0.0, 0, 0) for m in names
    }
    seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    fitted = _fit_methods(wf, train, names, k, machine_memory, dev)
    seconds["fit"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    if engine == "oracle":
        for fname in train:
            for mname in names:
                method = fitted[fname][mname]
                fam_gbs = 0.0
                for e in test[fname]:
                    plan = method.predict(e.input_gb)
                    res = simulate_execution(
                        plan, method.retry, e.mem, e.dt,
                        machine_memory=machine_memory,
                    )
                    fam_gbs += res.wastage_gbs
                    results[mname].retries += res.num_retries
                    results[mname].failures += 0 if res.succeeded else 1
                results[mname].per_family_gbs[fname] = fam_gbs
                results[mname].total_gbs += fam_gbs
        seconds["replay"] = time.perf_counter() - t0
        return ExperimentResult(wf.name, seed, train_frac, results, seconds,
                                fitted)

    # Fleet path: flatten the whole test split into one lane batch, bucketed
    # once and shared across methods (and, online, across rounds).
    flat = [(fname, e) for fname in train for e in test[fname]]
    for mname in names:
        for fname in train:
            results[mname].per_family_gbs[fname] = 0.0
    if not flat:
        return ExperimentResult(wf.name, seed, train_frac, results, seconds,
                                fitted)
    if len({e.dt for _, e in flat}) != 1:
        raise ValueError("fleet engine needs a uniform dt")
    traces = bucket_traces([e.mem for _, e in flat], device=dev)
    fam_idx = np.asarray(
        [list(train).index(fname) for fname, _ in flat], np.int64)

    if mode == "offline":
        t0 = time.perf_counter()
        jobs = _method_jobs(fitted, train, test, names)
        seconds["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet = simulate_fleet_many(
            jobs, traces, flat[0][1].dt, machine_memory=machine_memory)
        _aggregate_fleet(results, fleet, names, train, fam_idx)
        seconds["replay"] = time.perf_counter() - t0
        return ExperimentResult(wf.name, seed, train_frac, results, seconds,
                                fitted)

    # Online replay: the i-th `round_size` executions of every family share
    # an event time; ALL methods still replay each round in the usual two
    # compacted phases, then observations and refits are batched per
    # (family, method) at the round boundary.  Per-family packed
    # predictions are cached and invalidated only by an actual refit, so a
    # family whose model never changes predicts exactly once — with
    # `refit="never"` the prediction work equals the offline replay's.
    B = len(flat)
    within = np.zeros((B,), np.int64)  # index within its family
    seen: Dict[str, int] = {}
    for i, (fname, _) in enumerate(flat):
        within[i] = seen.get(fname, 0)
        seen[fname] = within[i] + 1
    n_rounds = int(within.max()) // round_size + 1
    online = {m: registry.get_spec(m).online for m in names}
    wastage = {m: np.zeros((B,), np.float64) for m in names}
    attempts = {m: np.ones((B,), np.int64) for m in names}
    succeeded = {m: np.zeros((B,), bool) for m in names}
    pred_cache: Dict[tuple, tuple] = {}  # (family, method) -> packed plans

    def family_plans(fname, mname):
        sp = pred_cache.get((fname, mname))
        if sp is None:
            sp = pred_cache[(fname, mname)] = packed_predict(
                fitted[fname][mname],
                [e.input_gb for e in test[fname]])
        return sp

    for r in range(n_rounds):
        lanes = np.nonzero(within // round_size == r)[0]
        by_fam: Dict[str, list] = {}
        for i in lanes:
            fname, e = flat[i]
            by_fam.setdefault(fname, []).append((int(i), e))
        jobs = []
        for mname in names:
            parts = []
            for fname in train:
                pairs = by_fam.get(fname)
                if not pairs:
                    continue
                sp = family_plans(fname, mname)
                sub = within[[i for i, _ in pairs]]
                parts.append((sp[0][sub], sp[1][sub], sp[2][sub]))
            specs = {fitted[fname][mname].retry_spec for fname in train}
            assert len(specs) == 1, \
                f"{mname}: retry spec differs across families"
            sp = concat_packed(parts)
            K = sp[0].shape[1]
            starts = np.full((B, K), PAD_START, np.float32)
            peaks = np.ones((B, K), np.float32)
            nseg = np.ones((B,), np.int32)
            starts[lanes], peaks[lanes], nseg[lanes] = sp
            jobs.append(((starts, peaks, nseg), specs.pop()))
        fleet = simulate_fleet_many(
            jobs, subset_batch(traces, lanes), flat[0][1].dt,
            machine_memory=machine_memory)
        for mname, fr in zip(names, fleet):
            wastage[mname][lanes] = fr.wastage_gbs[lanes]
            attempts[mname][lanes] = fr.attempts[lanes]
            succeeded[mname][lanes] = fr.succeeded[lanes]
        if policy.kind == "never" or r == n_rounds - 1:
            # "never": no refit can ever consume the observations; final
            # round: the refitted models would never predict again.
            continue
        keys = []
        for mname in names:
            if not online[mname]:
                continue
            for fname, pairs in by_fam.items():
                method = fitted[fname][mname]
                for i, e in pairs:
                    method.observe(ExecutionOutcome(
                        mem=e.mem, dt=e.dt, input_gb=e.input_gb,
                        succeeded=bool(succeeded[mname][i]),
                        retries=int(attempts[mname][i] - 1)))
                keys.append((fname, mname))
        # One compacted refit pass per event time: every due family's
        # tail segments in one call per segment count.
        did = refit_batched([fitted[f][m] for f, m in keys], policy)
        for (fname, mname), flag in zip(keys, did):
            if flag:
                pred_cache.pop((fname, mname), None)

    fleet = [FleetResult(wastage_gbs=wastage[m], attempts=attempts[m],
                         succeeded=succeeded[m]) for m in names]
    _aggregate_fleet(results, fleet, names, train, fam_idx)
    seconds["replay"] = time.perf_counter() - t0
    return ExperimentResult(wf.name, seed, train_frac, results, seconds,
                            fitted)


def run_paper_experiment(
    wf: Workflow,
    *,
    seeds=range(10),
    train_fracs=(0.25, 0.50, 0.75),
    k: int = 4,
    machine_memory: float = 128.0,
    methods: Optional[List[str]] = None,
    dt: float = 1.0,
    engine: str = "fleet",
    mode: str = "offline",
    refit: Union[RefitPolicy, str] = "never",
    round_size: int = 1,
    device=None,
):
    """Fig. 6 protocol: 10 seeds × {25, 50, 75}% training data, averaged.

    ``wf`` is a :class:`repro_torch.traces.generator.Workflow`; ``device``
    as in :func:`evaluate_workflow` (None means the card).
    """
    wf = _as_workflow(wf)
    device = resolve_device(device)
    out: Dict[float, Dict[str, float]] = {}
    for frac in train_fracs:
        acc: Dict[str, List[float]] = {}
        for seed in seeds:
            res = evaluate_workflow(
                wf, seed=seed, train_frac=frac, k=k,
                machine_memory=machine_memory, methods=methods, dt=dt,
                engine=engine, mode=mode, refit=refit, round_size=round_size,
                device=device,
            )
            for name, mr in res.methods.items():
                acc.setdefault(name, []).append(mr.total_gbs)
        out[frac] = {name: float(np.mean(v)) for name, v in acc.items()}
    return out
