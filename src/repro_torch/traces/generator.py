"""Synthetic workflow-trace generator.

The paper evaluates on monitoring traces of two nf-core workflows (*eager*
and *sarek*).  Those traces are not redistributable here, so this module
synthesizes statistically faithful stand-ins:

* each *task family* is a sequence of phases whose durations scale
  differently with the aggregated input size (paper §II-B: "the execution
  time of the first process of a task might scale linearly with the input
  size, while the second process might always take a constant amount"),
* memory within a phase is flat or ramps linearly (data loading),
* timing noise is heteroscedastic — absolute deviation grows with runtime
  (paper Fig. 3),
* the *eager* family set reproduces the BWA profile of Fig. 1 (long ~5 GB
  phase, then a step to ~10.7 GB at ~80 % of the runtime; median peak
  ≈ 10.6 GB) and the workflow-level average peak ≈ 2.3 GB; *sarek* has more
  instances and a lower average peak ≈ 1.7 GB (Fig. 5).

Every execution is reproducible from ``(workflow seed, family, index)``.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["Phase", "TaskFamily", "Execution", "Workflow", "eager", "sarek"]


@dataclasses.dataclass(frozen=True)
class Phase:
    """One phase of a task's lifetime.

    duration = dur_base + dur_per_gb * I   (seconds, before timing noise)
    level    = mem_base + mem_per_gb * I   (GB, before memory noise)
    ramp:    'flat' holds the level; 'linear' ramps from the previous
             phase's level up to this one (e.g. loading an index).
    """

    dur_base: float
    dur_per_gb: float
    mem_base: float
    mem_per_gb: float
    ramp: str = "flat"


@dataclasses.dataclass(frozen=True)
class TaskFamily:
    name: str
    phases: Tuple[Phase, ...]
    input_median_gb: float
    input_sigma: float = 0.30       # lognormal shape of input sizes
    timing_sigma: float = 0.14      # base relative timing noise
    timing_growth: float = 0.010    # extra relative noise per sqrt(second)
    mem_sigma: float = 0.03         # per-execution multiplicative memory noise
    default_limit_gb: float = 8.0   # the workflow developers' static limit

    def sample_input(self, rng: np.random.Generator) -> float:
        return float(
            self.input_median_gb * np.exp(rng.normal(0.0, self.input_sigma))
        )

    def generate(self, input_gb: float, rng: np.random.Generator,
                 dt: float = 1.0) -> np.ndarray:
        """Memory trace (GB per ``dt`` sample) for one execution."""
        mem_factor = float(np.exp(rng.normal(0.0, self.mem_sigma)))
        samples: List[np.ndarray] = []
        prev_level = 0.05
        for ph in self.phases:
            dur = ph.dur_base + ph.dur_per_gb * input_gb
            # Heteroscedastic timing noise: grows with nominal duration.
            rel = self.timing_sigma + self.timing_growth * np.sqrt(max(dur, 0.0))
            dur *= float(np.exp(rng.normal(0.0, rel)))
            n = max(int(round(dur / dt)), 1)
            level = (ph.mem_base + ph.mem_per_gb * input_gb) * mem_factor
            if ph.ramp == "linear":
                seg = np.linspace(prev_level, level, n, endpoint=True)
            else:
                seg = np.full(n, level)
            samples.append(seg)
            prev_level = level
        mem = np.concatenate(samples)
        mem = mem * (1.0 + rng.normal(0.0, 0.004, mem.shape))  # sampling jitter
        return np.maximum(mem, 0.01)


@dataclasses.dataclass(frozen=True)
class Execution:
    family: str
    input_gb: float
    dt: float
    mem: np.ndarray  # (L,) GB

    @property
    def runtime(self) -> float:
        return len(self.mem) * self.dt

    @property
    def peak(self) -> float:
        return float(np.max(self.mem))


@dataclasses.dataclass
class Workflow:
    """A named set of task families with per-family instance counts."""

    name: str
    families: Dict[str, TaskFamily]
    instances: Dict[str, int]

    def generate(self, seed: int, dt: float = 1.0) -> Dict[str, List[Execution]]:
        out: Dict[str, List[Execution]] = {}
        for fname, fam in self.families.items():
            rng = np.random.default_rng(
                np.random.SeedSequence(
                    [seed, zlib.crc32(fname.encode()) % (2**31)])
            )
            execs = []
            for _ in range(self.instances[fname]):
                I = fam.sample_input(rng)
                execs.append(
                    Execution(fname, I, dt, fam.generate(I, rng, dt))
                )
            out[fname] = execs
        return out

    def split(self, seed: int, train_frac: float, dt: float = 1.0):
        """Seeded train/test split per family (paper: 10 seeds × 25/50/75 %)."""
        data = self.generate(seed, dt)
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        train: Dict[str, List[Execution]] = {}
        test: Dict[str, List[Execution]] = {}
        for fname, execs in data.items():
            perm = rng.permutation(len(execs))
            n_train = max(int(round(train_frac * len(execs))), 2)
            idx_train = set(perm[:n_train].tolist())
            train[fname] = [e for i, e in enumerate(execs) if i in idx_train]
            test[fname] = [e for i, e in enumerate(execs) if i not in idx_train]
        return train, test


def _fam(name, phases, med, limit, **kw) -> TaskFamily:
    return TaskFamily(name=name, phases=tuple(phases), input_median_gb=med,
                      default_limit_gb=limit, **kw)


def eager(instances_per_family: int = 40) -> Workflow:
    """nf-core/eager-like workflow: 9 predicted task families (paper Fig. 8).

    BWA matches Fig. 1: ~80 % of the runtime at ≈5.1 GB, then a step to
    ≈10.7 GB; median input ≈4.7 GB gives a median peak ≈10.6 GB (Fig. 1a).
    """
    fams = [
        # Phase durations scale *differently* with input size (paper §II-B):
        # the alignment stream scales strongly, the merge/sort tail is nearly
        # constant — so the step position drifts across any fixed-fraction
        # segment grid as inputs vary.
        _fam("bwa", [
            Phase(25.0, 3.0, 2.40, 0.58, ramp="linear"),   # index load
            Phase(60.0, 65.0, 2.40, 0.58),                 # alignment (~I)
            Phase(140.0, 2.0, 5.05, 1.18),                 # merge (const)
            Phase(12.0, 1.0, 5.55, 1.32),                  # sort/flush spike
        ], med=4.7, limit=16.0),
        _fam("adapterremoval", [
            Phase(20.0, 2.0, 0.22, 0.030, ramp="linear"),
            Phase(30.0, 30.0, 0.30, 0.055),
        ], med=4.0, limit=4.0),
        _fam("samtools_filter", [
            Phase(20.0, 9.0, 0.18, 0.045),
        ], med=4.0, limit=4.0),
        _fam("samtools_flagstat", [
            Phase(12.0, 4.0, 0.10, 0.012),
        ], med=4.0, limit=2.0),
        _fam("mtnucratio", [
            Phase(8.0, 10.0, 0.12, 0.020),
            Phase(25.0, 0.5, 0.30, 0.060),                 # const-time tail
        ], med=3.0, limit=2.0),
        _fam("dedup", [
            Phase(15.0, 6.0, 0.60, 0.220, ramp="linear"),
            Phase(30.0, 1.0, 1.10, 0.360),                 # const-time hash
            Phase(8.0, 0.5, 1.45, 0.50),
        ], med=3.5, limit=8.0),
        _fam("damageprofiler", [
            Phase(18.0, 5.0, 0.90, 0.110),
        ], med=3.0, limit=4.0),
        _fam("preseq", [
            Phase(15.0, 5.0, 0.35, 0.070),
        ], med=3.0, limit=2.0),
        _fam("qualimap", [
            Phase(12.0, 12.0, 0.55, 0.100, ramp="linear"),
            Phase(45.0, 1.0, 1.25, 0.160),                 # const-time report
        ], med=3.5, limit=6.0),
    ]
    return Workflow("eager", {f.name: f for f in fams},
                    {f.name: instances_per_family for f in fams})


def sarek(instances_per_family: int = 70) -> Workflow:
    """nf-core/sarek-like workflow: more instances, lower avg peak (Fig. 5)."""
    fams = [
        _fam("fastqc", [Phase(20.0, 4.0, 0.30, 0.012)], med=3.0, limit=4.0),
        _fam("bwamem2", [
            Phase(20.0, 2.0, 1.80, 0.40, ramp="linear"),
            Phase(40.0, 55.0, 1.80, 0.40),                 # streaming (~I)
            Phase(110.0, 2.0, 3.40, 0.75),                 # merge (const)
            Phase(10.0, 0.5, 3.80, 0.85),
        ], med=3.2, limit=12.0),
        _fam("markduplicates", [
            Phase(12.0, 14.0, 0.80, 0.25, ramp="linear"),
            Phase(55.0, 1.0, 1.60, 0.45),                  # const-time dedup
        ], med=3.0, limit=8.0),
        _fam("baserecalibrator", [
            Phase(35.0, 9.0, 0.70, 0.16),
        ], med=3.0, limit=6.0),
        _fam("applybqsr", [
            Phase(28.0, 8.0, 0.55, 0.12),
        ], med=3.0, limit=4.0),
        _fam("haplotypecaller", [
            Phase(15.0, 22.0, 0.70, 0.14, ramp="linear"),  # scan (~I)
            Phase(70.0, 1.0, 1.05, 0.24),                  # assembly (const)
            Phase(9.0, 0.5, 1.40, 0.34),
        ], med=2.8, limit=8.0),
        _fam("strelka", [
            Phase(40.0, 12.0, 0.85, 0.18),
        ], med=2.8, limit=6.0),
        _fam("mosdepth", [
            Phase(15.0, 5.0, 0.25, 0.040),
        ], med=3.0, limit=2.0),
        _fam("vcftools", [
            Phase(12.0, 3.0, 0.15, 0.020),
        ], med=2.0, limit=2.0),
        _fam("snpeff", [
            Phase(10.0, 8.0, 0.90, 0.05, ramp="linear"),
            Phase(32.0, 1.0, 1.30, 0.10),                  # const-time annot
        ], med=2.5, limit=6.0),
    ]
    return Workflow("sarek", {f.name: f for f in fams},
                    {f.name: instances_per_family for f in fams})
