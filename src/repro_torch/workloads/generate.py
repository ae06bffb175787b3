"""Seeded synthetic workload generation on a device (PyTorch).

:mod:`repro_torch.traces.generator` reproduces the paper's two nf-core
workflows but builds every execution in a Python loop.  This module is the
*scale* path: task-family recipes are synthesized **directly into the fleet
engine's packed ``(B, T)`` lane layout** on a device — per length bucket,
one batch of tensor operations materializes the whole ``(B, T)``
memory-over-time matrix from per-lane shape parameters, so a 10k-task fleet
costs a handful of batched steps instead of 10k Python-level trace
constructions.

Recipes compose three ingredients:

* a **parametric shape** (:data:`SHAPES`): ``plateau`` (flat), ``ramp``
  (load then hold), ``spike`` (flat with a short high excursion),
  ``sawtooth`` (periodic fill/flush cycles), ``phases`` (ascending step
  levels — the multi-phase profile KS+ segments),
* **input-size scaling laws**: durations and memory levels are affine in
  the task's (lognormal) input size, mirroring the paper's §II-B
  observation that phases scale differently with input size,
* **noise**: lognormal per-task duration/memory factors plus per-sample
  multiplicative jitter.

Each step is split in two: a *draw* of standard normals from a seeded
``torch.Generator`` on the device, and a pure float32 function of those
normals (:func:`scalars_from_normals`, :func:`traces_from_normals`) that
holds all the shape math.  The same ``(recipes, counts, seed, device)``
always gives the same workload bit for bit; CUDA and CPU generators draw
different streams, so a workload is moved between devices by carrying its
state (:func:`trace_state` → :func:`load_workflow_trace`), never by
synthesizing it again.

The output :class:`WorkflowTrace` carries the packed
:class:`repro_torch.core.fleet.FleetBatch` (its buckets live on the
device), per-task metadata and **DAG edges** (``parents``), and adapts into
every consumer: ``to_jobs`` for :class:`repro_torch.sched.cluster.ClusterSim`
(dependency-aware replay), ``to_workflow`` for
:func:`repro_torch.sched.simulator.evaluate_workflow`, raw ``mems()`` for
the fleet engine.  DAG shapes (chains, fan-out trees, random layered DAGs,
barrier waves) are built by the ``*_parents`` helpers; the wfcommons
importer (:mod:`repro_torch.workloads.wfc`) produces the same
representation.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.fleet import (
    FleetBatch,
    TraceBucket,
    _device_bucket,
    group_lengths,
)
from repro_torch.device import resolve_device

__all__ = [
    "SHAPES",
    "FamilyRecipe",
    "WorkflowTrace",
    "ScenarioWorkflow",
    "synthesize",
    "materialize_traces",
    "chain_parents",
    "fanout_parents",
    "layered_parents",
    "barrier_parents",
    "assert_release_order",
    "scalars_from_normals",
    "traces_from_normals",
    "trace_state",
    "load_workflow_trace",
]

SHAPES = ("plateau", "ramp", "spike", "sawtooth", "phases")


@dataclasses.dataclass(frozen=True)
class FamilyRecipe:
    """One task family: a shape plus input-size scaling laws and noise.

    ``duration = (dur_base + dur_per_gb * I) * lognormal(dur_sigma)`` and
    ``level = (mem_base + mem_per_gb * I) * lognormal(mem_sigma)`` with
    ``I ~ input_median_gb * lognormal(input_sigma)``; the shape modulates
    ``level`` over normalized time.  Two recipes may share a ``name`` —
    their tasks then belong to one task family (the hetero-dt scenario
    mixes sampling periods inside a family this way).
    """

    name: str
    shape: str = "plateau"
    dur_base: float = 30.0
    dur_per_gb: float = 10.0
    mem_base: float = 0.5
    mem_per_gb: float = 0.25
    input_median_gb: float = 3.0
    input_sigma: float = 0.30
    dur_sigma: float = 0.10
    mem_sigma: float = 0.05
    noise: float = 0.01          # per-sample multiplicative jitter
    dt: float = 1.0
    default_limit_gb: float = 8.0
    # Shape parameters (meaning depends on ``shape``):
    ramp_frac: float = 0.6       # ramp: fraction of runtime spent ramping
    spike_pos: float = 0.8       # spike: center (fraction of runtime)
    spike_frac: float = 0.08     # spike: width (fraction of runtime)
    spike_gain: float = 2.0      # spike: height multiplier on the plateau
    cycles: float = 4.0          # sawtooth: fill/flush cycles
    n_phases: float = 3.0        # phases: number of ascending steps

    def __post_init__(self):
        if self.shape not in SHAPES:
            raise ValueError(
                f"unknown shape {self.shape!r} (choose from {SHAPES})")


# One packed parameter triple per lane; meaning depends on the shape id.
_SHAPE_ID = {s: i for i, s in enumerate(SHAPES)}


def _recipe_params(r: FamilyRecipe) -> Tuple[float, float, float]:
    if r.shape == "ramp":
        return (r.ramp_frac, 0.0, 0.0)
    if r.shape == "spike":
        return (r.spike_frac, r.spike_pos, r.spike_gain)
    if r.shape == "sawtooth":
        return (0.0, 0.0, r.cycles)
    if r.shape == "phases":
        return (0.0, 0.0, r.n_phases)
    return (0.0, 0.0, 0.0)  # plateau


def _generator(device: torch.device, *words: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a tagged
    ``SeedSequence`` over ``words`` (63 bits of its state)."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> 1))


def scalars_from_normals(z: torch.Tensor, r: FamilyRecipe):
    """Per-task input sizes, durations and memory levels of one family from
    its standard normals ``z`` (``(3, n)`` float32): ``I``, ``dur`` and
    ``level``, each ``(n,)`` float32."""
    I = r.input_median_gb * torch.exp(r.input_sigma * z[0])
    dur = (r.dur_base + r.dur_per_gb * I) * torch.exp(r.dur_sigma * z[1])
    level = (r.mem_base + r.mem_per_gb * I) * torch.exp(r.mem_sigma * z[2])
    return I, dur, level


def traces_from_normals(z: torch.Tensor, shape_id: torch.Tensor,
                        level: torch.Tensor, lengths: torch.Tensor,
                        p1: torch.Tensor, p2: torch.Tensor, p3: torch.Tensor,
                        noise: torch.Tensor) -> torch.Tensor:
    """The ``(B, T)`` memory matrix of one length bucket from its per-sample
    standard normals ``z`` (``(B, T)`` float32): every lane's shape on the
    shared sample grid, then per-sample jitter.  Samples at or past a
    lane's length are zero.  Per-lane inputs are ``(B,)``, float32 except
    the integer ``lengths``."""
    T = z.shape[1]
    t = torch.arange(T, dtype=torch.float32, device=z.device)[None, :]
    Lr = lengths.to(torch.float32)[:, None]
    u = t / Lr.clamp_min(1.0)                   # normalized time [0, 1)
    lev = level[:, None]
    a, c, g = p1[:, None], p2[:, None], p3[:, None]
    sid = shape_id[:, None]
    gm = g.clamp_min(1.0)
    ramp = lev * (0.15 + 0.85 * torch.clamp_max(u / a.clamp_min(1e-6), 1.0))
    spike = lev * torch.where((u - c).abs() <= a * 0.5, g, 1.0)
    saw = lev * (0.30 + 0.70 * torch.remainder(u * gm, 1.0))
    phases = lev * (0.30 + 0.70 * (torch.floor(u * gm) + 1.0) / gm)
    mem = torch.where(sid == 4, phases, lev)
    mem = torch.where(sid == 3, saw, mem)
    mem = torch.where(sid == 2, spike, mem)
    mem = torch.where(sid == 1, ramp, mem)
    mem = torch.where(sid == 0, lev, mem)
    mem = torch.clamp_min(mem * (1.0 + noise[:, None] * z), 0.01)
    return torch.where(t < Lr, mem, 0.0)


def materialize_traces(shape_id: np.ndarray, level: np.ndarray,
                       lengths: np.ndarray, params: np.ndarray,
                       noise: np.ndarray, seed: int, *,
                       device=None) -> FleetBatch:
    """Packed ``(B, T)`` lane traces from per-task shape parameters.

    The shared device path of the generator and the wfcommons importer:
    length-buckets the lanes (:func:`repro_torch.core.fleet.group_lengths`,
    the policy the fleet's own ``bucket_traces`` uses) and synthesizes each
    bucket on ``device`` (None means the card): one draw of its ``(b, T)``
    normals, :func:`traces_from_normals`, and one read back to the host
    copy the bucket keeps.  Returns a ready-to-probe :class:`FleetBatch`
    whose bucket ``idx`` is the task index space.
    """
    dev = resolve_device(device)
    lengths = np.asarray(lengths, np.int64)

    def lane(a, idx, dtype=np.float32):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(a, dtype)[idx])).to(dev)

    buckets = []
    for bi, (T, idx) in enumerate(group_lengths(lengths)):
        z = torch.randn((len(idx), T), generator=_generator(dev, seed, bi),
                        device=dev, dtype=torch.float32)
        dmems = traces_from_normals(
            z, lane(shape_id, idx), lane(level, idx),
            lane(lengths, idx, np.int64), lane(params[:, 0], idx),
            lane(params[:, 1], idx), lane(params[:, 2], idx),
            lane(noise, idx))
        mems = dmems.cpu().numpy()
        plen = lengths[idx].astype(np.int32)
        summem = mems.sum(axis=1, dtype=np.float64).astype(np.float32)
        buckets.append(TraceBucket(
            idx=idx, mems=mems, lengths=plen, dmems=dmems,
            dlengths=torch.from_numpy(plen).to(dev),
            dsummem=torch.from_numpy(summem).to(dev)))
    return FleetBatch(n=int(len(lengths)), buckets=tuple(buckets),
                      device=dev)


# --------------------------------------------------------------- DAG shapes
def chain_parents(B: int, chains: int = 1) -> Tuple[Tuple[int, ...], ...]:
    """``chains`` interleaved deep chains: task i depends on i - chains."""
    return tuple(() if i < chains else (i - chains,) for i in range(B))


def fanout_parents(B: int, fanout: int = 8) -> Tuple[Tuple[int, ...], ...]:
    """A ``fanout``-ary tree rooted at task 0 (wide fan-out release)."""
    return tuple(() if i == 0 else ((i - 1) // fanout,) for i in range(B))


def layered_parents(B: int, seed: int = 0, layer_width: int = 64,
                    max_parents: int = 3) -> Tuple[Tuple[int, ...], ...]:
    """Random layered DAG: tasks in layer L draw 1..max_parents parents
    uniformly from layer L-1 (seeded, deterministic)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xDA6]))
    parents: List[Tuple[int, ...]] = []
    for i in range(B):
        layer = i // layer_width
        if layer == 0:
            parents.append(())
            continue
        lo, hi = (layer - 1) * layer_width, min(layer * layer_width, B)
        k = int(rng.integers(1, max_parents + 1))
        ps = rng.choice(np.arange(lo, hi), size=min(k, hi - lo),
                        replace=False)
        parents.append(tuple(int(p) for p in sorted(ps)))
    return tuple(parents)


def barrier_parents(B: int, waves: int = 8) -> Tuple[Tuple[int, ...], ...]:
    """Burst-arrival structure: tasks split into ``waves``; every task of
    wave w depends on wave w-1's *pilot* (its first task), so whole waves
    release at once — the cluster sees bursts, not a steady trickle."""
    per = max(B // waves, 1)
    parents: List[Tuple[int, ...]] = []
    for i in range(B):
        wave = min(i // per, waves - 1)
        if wave == 0:
            parents.append(())
        else:
            parents.append(((wave - 1) * per,))
    return tuple(parents)


# ------------------------------------------------------------ WorkflowTrace
@dataclasses.dataclass
class WorkflowTrace:
    """A workload: packed lane traces + per-task metadata + DAG edges.

    Lane ``i`` of ``batch`` is task ``i``; ``parents[i]`` are task indices
    that must finish before task ``i`` may start (empty tuple = root).
    The wfcommons importer and the synthetic generator both produce this.
    """

    name: str
    task_ids: List[str]
    families: List[str]
    input_gb: np.ndarray                 # (B,) float64
    dts: np.ndarray                      # (B,) float64
    lengths: np.ndarray                  # (B,) int64
    parents: Tuple[Tuple[int, ...], ...]
    batch: FleetBatch
    default_limits: Dict[str, float]
    release_times: Optional[np.ndarray] = None  # (B,) float64, roots only
    _loc: Optional[np.ndarray] = None    # (B, 2): bucket #, row #

    def __post_init__(self):
        loc = np.zeros((self.B, 2), np.int64)
        for bi, bucket in enumerate(self.batch.buckets):
            loc[bucket.idx, 0] = bi
            loc[bucket.idx, 1] = np.arange(len(bucket.idx))
        self._loc = loc

    @property
    def B(self) -> int:
        return int(self.batch.n)

    def mem(self, i: int) -> np.ndarray:
        """Task ``i``'s memory trace (float64 copy of its packed lane)."""
        bi, row = self._loc[i]
        bucket = self.batch.buckets[bi]
        return np.asarray(bucket.mems[row, : self.lengths[i]], np.float64)

    def mems(self) -> List[np.ndarray]:
        return [self.mem(i) for i in range(self.B)]

    def peaks(self) -> np.ndarray:
        """Per-task peak memory (GB), straight from the packed lanes."""
        out = np.zeros((self.B,), np.float64)
        for bucket in self.batch.buckets:
            valid = (np.arange(bucket.mems.shape[1])[None, :]
                     < bucket.lengths[:, None])
            out[bucket.idx] = np.max(
                np.where(valid, bucket.mems, 0.0), axis=1)
        return out

    def runtimes(self) -> np.ndarray:
        return self.lengths * self.dts

    # ------------------------------------------------------------- adapters
    def to_jobs(self, plans=None, *, margin: float = 1.12,
                under_frac: float = 0.0, seed: int = 0):
        """ClusterSim jobs (with DAG edges) for this workload.

        ``plans`` may be per-task :class:`AllocationPlan`s (e.g. from a
        fitted method); without them, 2-segment oracle-with-margin plans
        are derived from the hidden traces — ``under_frac`` of the tasks
        get an under-allocated second segment so the OOM/retry path is
        exercised (seeded, deterministic).
        """
        from repro_torch.core.allocation import AllocationPlan
        from repro_torch.sched.cluster import Job

        rng = np.random.default_rng(np.random.SeedSequence([seed, 0x70B5]))
        under = rng.uniform(size=self.B) < under_frac
        jobs = []
        for i in range(self.B):
            mem = self.mem(i)
            if plans is not None:
                plan = plans[i]
            else:
                L = len(mem)
                split = max(int(0.5 * L), 1)
                head = float(mem[:split].max())
                peak = float(mem.max())
                scale = 0.93 if under[i] else margin
                plan = AllocationPlan(
                    starts=np.asarray([0.0, max((split - 2) * self.dts[i],
                                                self.dts[i])]),
                    peaks=np.asarray([head * margin,
                                      max(peak * scale, head * margin)]))
            jobs.append(Job(
                jid=i, family=self.families[i],
                input_gb=float(self.input_gb[i]), mem=mem,
                dt=float(self.dts[i]), plan=plan,
                est_runtime=float(self.lengths[i] * self.dts[i]),
                parents=tuple(self.parents[i]),
                release_time=(0.0 if self.release_times is None
                              else float(self.release_times[i]))))
        return jobs

    def to_workflow(self) -> "ScenarioWorkflow":
        """Adapter for
        :func:`repro_torch.sched.simulator.evaluate_workflow`."""
        from repro_torch.traces.generator import Execution

        execs: Dict[str, List] = {}
        for i in range(self.B):
            execs.setdefault(self.families[i], []).append(Execution(
                self.families[i], float(self.input_gb[i]),
                float(self.dts[i]), self.mem(i)))
        fams = {f: _FamilyView(f, self.default_limits.get(f, 8.0))
                for f in execs}
        return ScenarioWorkflow(name=self.name, families=fams, _execs=execs)


@dataclasses.dataclass(frozen=True)
class _FamilyView:
    name: str
    default_limit_gb: float


@dataclasses.dataclass
class ScenarioWorkflow:
    """Duck-typed :class:`repro_torch.traces.generator.Workflow` over a
    materialized :class:`WorkflowTrace` — ``evaluate_workflow`` and
    ``run_paper_experiment`` consume it unchanged.  The executions are
    fixed (the trace's own seed governs them); ``split`` seeds only the
    train/test permutation, exactly like ``Workflow.split``.
    """

    name: str
    families: Dict[str, _FamilyView]
    _execs: Dict[str, List]

    def generate(self, seed: int = 0, dt: float = 1.0):
        return self._execs

    def split(self, seed: int, train_frac: float, dt: float = 1.0):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        train: Dict[str, List] = {}
        test: Dict[str, List] = {}
        for fname, execs in self._execs.items():
            perm = rng.permutation(len(execs))
            n_train = max(int(round(train_frac * len(execs))), 2)
            idx_train = set(perm[:n_train].tolist())
            train[fname] = [e for i, e in enumerate(execs) if i in idx_train]
            test[fname] = [e for i, e in enumerate(execs)
                           if i not in idx_train]
        return train, test


# ---------------------------------------------------------------- generator
def synthesize(recipes: Sequence[FamilyRecipe], counts,
               seed: int = 0, *, name: str = "synthetic",
               parents: Optional[Sequence[Sequence[int]]] = None,
               device=None) -> WorkflowTrace:
    """Generate a workload straight into packed lanes on ``device`` (None
    means the card).

    ``counts`` is per-recipe instance counts (an int applies to every
    recipe).  Tasks are laid out recipe-major (recipe 0's tasks first), so
    ``parents`` — per-task parent indices, e.g. from
    :func:`layered_parents` — refers to that order.  One draw and one host
    read of the task scalars per recipe, then one synthesis per length
    bucket (:func:`materialize_traces`).
    """
    if isinstance(counts, int):
        counts = [counts] * len(recipes)
    if len(counts) != len(recipes):
        raise ValueError(f"{len(counts)} counts vs {len(recipes)} recipes")
    dev = resolve_device(device)

    shape_id, level, lengths, params, noise = [], [], [], [], []
    families: List[str] = []
    task_ids: List[str] = []
    input_gb, dts = [], []
    limits: Dict[str, float] = {}
    for ri, (r, n) in enumerate(zip(recipes, counts)):
        if n <= 0:
            continue
        # Seed with the recipe *position* as well as its identity: two
        # recipes that happen to share (name, shape, dt) must still draw
        # independent task populations.
        crc = zlib.crc32(f"{r.name}/{r.shape}/{r.dt}".encode()) % (2 ** 31)
        z = torch.randn((3, int(n)), generator=_generator(dev, seed, ri, crc),
                        device=dev, dtype=torch.float32)
        I, dur, lev = torch.stack(scalars_from_normals(z, r)).cpu().numpy()
        I = np.asarray(I, np.float64)
        L = np.maximum(np.round(np.asarray(dur, np.float64) / r.dt), 2.0)
        base = len(families)
        families.extend([r.name] * n)
        task_ids.extend(f"{r.name}_{base + j:08d}" for j in range(n))
        input_gb.append(I)
        dts.append(np.full((n,), float(r.dt)))
        lengths.append(L.astype(np.int64))
        shape_id.append(np.full((n,), _SHAPE_ID[r.shape], np.float32))
        level.append(lev)
        params.append(np.tile(np.asarray(_recipe_params(r), np.float32),
                              (n, 1)))
        noise.append(np.full((n,), r.noise, np.float32))
        limits.setdefault(r.name, r.default_limit_gb)

    lengths = np.concatenate(lengths)
    batch = materialize_traces(
        np.concatenate(shape_id), np.concatenate(level), lengths,
        np.concatenate(params), np.concatenate(noise), seed, device=dev)
    B = batch.n
    if parents is None:
        parents = tuple(() for _ in range(B))
    else:
        if len(parents) != B:
            raise ValueError(f"{len(parents)} parent lists vs {B} tasks")
        parents = tuple(tuple(int(p) for p in ps) for ps in parents)
    return WorkflowTrace(
        name=name, task_ids=task_ids, families=families,
        input_gb=np.concatenate(input_gb), dts=np.concatenate(dts),
        lengths=lengths, parents=parents, batch=batch,
        default_limits=limits)


# ------------------------------------------------------------ carried state
def trace_state(trace) -> dict:
    """The numpy state of a workflow trace: task ids, families, input
    sizes, dts, lengths, parents, release times, default limits, name and
    the packed lanes (``buckets``: one ``(idx, mems, lengths)`` per length
    bucket, host copies).

    Reads only attributes, so it takes this package's :class:`WorkflowTrace`
    or any object with the same fields; :func:`load_workflow_trace` builds
    a trace on a device from it.
    """
    rel = trace.release_times
    return {
        "name": str(trace.name),
        "task_ids": [str(x) for x in trace.task_ids],
        "families": [str(x) for x in trace.families],
        "input_gb": np.array(trace.input_gb, np.float64),
        "dts": np.array(trace.dts, np.float64),
        "lengths": np.array(trace.lengths, np.int64),
        "parents": tuple(tuple(int(p) for p in ps) for ps in trace.parents),
        "release_times": None if rel is None else np.array(rel, np.float64),
        "default_limits": {str(k): float(v)
                           for k, v in trace.default_limits.items()},
        "buckets": [(np.array(b.idx, np.int64), np.array(b.mems, np.float32),
                     np.array(b.lengths, np.int32))
                    for b in trace.batch.buckets],
    }


def load_workflow_trace(arrays, device=None) -> WorkflowTrace:
    """A :class:`WorkflowTrace` on ``device`` (None means the card) from
    carried state: a :func:`trace_state` mapping, or a workflow trace
    object (its state is read first).

    The packed lanes are uploaded as they are, and each bucket's per-lane
    sum is reduced from them in float64 as the generator reduces it, so the
    carried trace replays exactly as the original does.
    """
    if not isinstance(arrays, Mapping):
        arrays = trace_state(arrays)
    dev = resolve_device(device)
    buckets = []
    for idx, mems, lengths in arrays["buckets"]:
        mems = np.ascontiguousarray(mems, np.float32)
        summem = mems.sum(axis=1, dtype=np.float64).astype(np.float32)
        buckets.append(_device_bucket(
            np.asarray(idx, np.int64), mems,
            np.ascontiguousarray(lengths, np.int32), summem, dev))
    lengths = np.asarray(arrays["lengths"], np.int64)
    rel = arrays.get("release_times")
    return WorkflowTrace(
        name=str(arrays["name"]), task_ids=list(arrays["task_ids"]),
        families=list(arrays["families"]),
        input_gb=np.asarray(arrays["input_gb"], np.float64),
        dts=np.asarray(arrays["dts"], np.float64), lengths=lengths,
        parents=tuple(tuple(int(p) for p in ps)
                      for ps in arrays["parents"]),
        batch=FleetBatch(n=int(len(lengths)), buckets=tuple(buckets),
                         device=dev),
        default_limits=dict(arrays["default_limits"]),
        release_times=None if rel is None else np.asarray(rel, np.float64))


# ----------------------------------------------------------- DAG validation
def assert_release_order(jobs, placements) -> None:
    """Check a ClusterSim placement log against the jobs' DAG.

    For every placed job, its *first* placement must come at or after every
    parent's finish time (last placement + runtime), and no job may be
    placed while a parent was never placed.  Exact for workloads without
    permanent failures (every placed job eventually finishes); the
    dependency-correctness assertion behind the ``workload_replay``
    benchmark and the DAG tests.
    """
    first: Dict[int, float] = {}
    last: Dict[int, float] = {}
    for t, _, jid in placements:
        first.setdefault(jid, t)
        last[jid] = t
    by_jid = {job.jid: job for job in jobs}
    for job in jobs:
        if job.jid not in first:
            continue
        for p in job.parents:
            if p not in last:
                raise AssertionError(
                    f"job {job.jid} was placed but its parent {p} never was")
            parent_end = last[p] + by_jid[p].runtime
            if first[job.jid] < parent_end - 1e-9:
                raise AssertionError(
                    f"job {job.jid} placed at t={first[job.jid]:.3f} before "
                    f"parent {p} finished at t={parent_end:.3f}")
