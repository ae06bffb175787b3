"""Named scenario catalog — stress workloads beyond the paper's two.

Each scenario is a seeded factory ``(n_tasks, seed) -> WorkflowTrace``
registered under a stable name, so tests, benchmarks and harness code all
pull the same workloads by name:

=================  =========================================================
``burst_arrival``  Barrier-wave DAG: whole waves release at once, slamming
                   the admission queue in bursts instead of a trickle.
``heavy_tail``     Heavy-tailed (lognormal, large sigma) memory and
                   duration — a few elephants among many mice; no DAG.
``deep_chain``     Interleaved deep dependency chains: release order is
                   serial per chain, parallel across chains.
``wide_fanout``    8-ary fan-out tree from one root: near-total
                   parallelism one hop after the root finishes.
``hetero_dt``      Families with different sampling periods, including one
                   family whose *own* history mixes dts (exercises
                   ``KSPlusAuto``'s hetero-dt policy once per process).
=================  =========================================================

``evaluate_workflow`` accepts these names directly (they adapt through
:meth:`WorkflowTrace.to_workflow`); ClusterSim replays come from
:meth:`WorkflowTrace.to_jobs`, DAG edges included.  Every scenario is
synthesized on the device :func:`get` is given (None means the card).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.workloads.generate import (
    FamilyRecipe,
    WorkflowTrace,
    barrier_parents,
    chain_parents,
    fanout_parents,
    layered_parents,
    synthesize,
)

__all__ = ["ScenarioSpec", "SCENARIOS", "register_scenario",
           "scenario_names", "get"]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    name: str
    description: str
    factory: Callable[..., WorkflowTrace]
    default_n: int = 512


SCENARIOS: Dict[str, ScenarioSpec] = {}


def register_scenario(name: str, description: str, default_n: int = 512):
    """Decorator: register ``factory(n_tasks, seed, *, device)`` as
    scenario ``name``."""
    def deco(factory):
        if name in SCENARIOS:
            raise ValueError(f"scenario already registered: {name!r}")
        SCENARIOS[name] = ScenarioSpec(
            name=name, description=description, factory=factory,
            default_n=default_n)
        return factory
    return deco


def scenario_names() -> List[str]:
    return list(SCENARIOS)


def get(name: str, *, n_tasks: Optional[int] = None,
        seed: int = 0, device=None) -> WorkflowTrace:
    """Build a catalog scenario by name on ``device`` (None means the
    card)."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario: {name!r} "
                       f"(registered: {', '.join(SCENARIOS)})")
    spec = SCENARIOS[name]
    return spec.factory(n_tasks if n_tasks is not None else spec.default_n,
                        seed, device=device)


def _split_counts(n: int, weights) -> List[int]:
    """Split ``n`` tasks across families by weight: every family gets at
    least one task (so tiny ``n`` is clamped to the family count) and the
    rounding drift is absorbed by the largest families, never below 1."""
    n = max(n, len(weights))
    total = sum(weights)
    counts = [max(int(round(n * w / total)), 1) for w in weights]
    while sum(counts) != n:
        i = counts.index(max(counts))
        counts[i] = max(counts[i] + (1 if sum(counts) < n else -1), 1)
    return counts


@register_scenario(
    "burst_arrival",
    "barrier-wave DAG: whole waves of mixed-shape tasks release at once",
    default_n=512)
def _burst_arrival(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("pilot", shape="plateau", dur_base=20.0, dur_per_gb=2.0,
                     mem_base=0.4, mem_per_gb=0.05, default_limit_gb=2.0),
        FamilyRecipe("burst_ramp", shape="ramp", dur_base=40.0,
                     dur_per_gb=12.0, mem_base=1.2, mem_per_gb=0.5,
                     ramp_frac=0.5, default_limit_gb=8.0),
        FamilyRecipe("burst_spike", shape="spike", dur_base=35.0,
                     dur_per_gb=8.0, mem_base=0.9, mem_per_gb=0.35,
                     spike_gain=2.4, default_limit_gb=8.0),
    ]
    counts = _split_counts(n_tasks, (1, 3, 3))
    wf = synthesize(recipes, counts, seed, name="burst_arrival",
                    device=device)
    return dataclasses.replace(
        wf, parents=barrier_parents(wf.B, waves=max(n_tasks // 64, 4)))


@register_scenario(
    "heavy_tail",
    "heavy-tailed memory/runtime mix (elephants among mice), no DAG",
    default_n=512)
def _heavy_tail(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("mice", shape="plateau", dur_base=15.0, dur_per_gb=4.0,
                     mem_base=0.2, mem_per_gb=0.08, input_sigma=0.4,
                     mem_sigma=0.25, default_limit_gb=2.0),
        FamilyRecipe("elephants", shape="phases", dur_base=90.0,
                     dur_per_gb=40.0, mem_base=2.0, mem_per_gb=1.4,
                     input_sigma=0.9, mem_sigma=0.8, dur_sigma=0.5,
                     n_phases=4.0, default_limit_gb=24.0),
        FamilyRecipe("saw_io", shape="sawtooth", dur_base=45.0,
                     dur_per_gb=10.0, mem_base=0.8, mem_per_gb=0.4,
                     mem_sigma=0.5, cycles=6.0, default_limit_gb=8.0),
    ]
    counts = _split_counts(n_tasks, (8, 1, 3))
    return synthesize(recipes, counts, seed, name="heavy_tail",
                      device=device)


@register_scenario(
    "deep_chain",
    "interleaved deep dependency chains (serial release per chain)",
    default_n=512)
def _deep_chain(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("stage", shape="ramp", dur_base=25.0, dur_per_gb=6.0,
                     mem_base=0.8, mem_per_gb=0.3, ramp_frac=0.4,
                     default_limit_gb=6.0),
        FamilyRecipe("checkpoint", shape="spike", dur_base=18.0,
                     dur_per_gb=3.0, mem_base=0.5, mem_per_gb=0.2,
                     spike_pos=0.9, spike_gain=1.8, default_limit_gb=4.0),
    ]
    counts = _split_counts(n_tasks, (3, 1))
    wf = synthesize(recipes, counts, seed, name="deep_chain",
                    device=device)
    return dataclasses.replace(
        wf, parents=chain_parents(wf.B, chains=max(n_tasks // 64, 4)))


@register_scenario(
    "wide_fanout",
    "8-ary fan-out tree from one root (mass release after one task)",
    default_n=512)
def _wide_fanout(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("scatter", shape="plateau", dur_base=20.0,
                     dur_per_gb=5.0, mem_base=0.4, mem_per_gb=0.15,
                     default_limit_gb=4.0),
        FamilyRecipe("leafwork", shape="ramp", dur_base=30.0,
                     dur_per_gb=9.0, mem_base=0.9, mem_per_gb=0.4,
                     default_limit_gb=8.0),
    ]
    counts = _split_counts(n_tasks, (1, 3))
    wf = synthesize(recipes, counts, seed, name="wide_fanout",
                    device=device)
    return dataclasses.replace(wf, parents=fanout_parents(wf.B, fanout=8))


@register_scenario(
    "hetero_dt",
    "families sampled at different dts, one family internally mixed",
    default_n=384)
def _hetero_dt(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("fast_probe", shape="spike", dur_base=30.0,
                     dur_per_gb=6.0, mem_base=0.6, mem_per_gb=0.25,
                     dt=0.5, default_limit_gb=4.0),
        FamilyRecipe("slow_batch", shape="phases", dur_base=80.0,
                     dur_per_gb=20.0, mem_base=1.2, mem_per_gb=0.5,
                     dt=2.0, n_phases=3.0, default_limit_gb=8.0),
        # One *family* with two sampling periods: its fit history is
        # heterogeneous, exercising KSPlusAuto's hetero_dt policy.
        FamilyRecipe("mixed", shape="ramp", dur_base=40.0, dur_per_gb=10.0,
                     mem_base=0.9, mem_per_gb=0.35, dt=1.0,
                     default_limit_gb=6.0),
        FamilyRecipe("mixed", shape="ramp", dur_base=40.0, dur_per_gb=10.0,
                     mem_base=0.9, mem_per_gb=0.35, dt=0.5,
                     default_limit_gb=6.0),
    ]
    counts = _split_counts(n_tasks, (1, 1, 1, 1))
    return synthesize(recipes, counts, seed, name="hetero_dt",
                      device=device)


@register_scenario(
    "workload_replay",
    "layered random DAG at fleet scale — the workload_replay benchmark",
    default_n=5120)
def _workload_replay(n_tasks: int, seed: int, *, device) -> WorkflowTrace:
    recipes = [
        FamilyRecipe("etl", shape="ramp", dur_base=24.0, dur_per_gb=6.0,
                     mem_base=1.0, mem_per_gb=0.4, ramp_frac=0.5,
                     default_limit_gb=8.0),
        FamilyRecipe("train", shape="phases", dur_base=40.0,
                     dur_per_gb=10.0, mem_base=1.6, mem_per_gb=0.6,
                     n_phases=3.0, default_limit_gb=12.0),
        FamilyRecipe("score", shape="plateau", dur_base=16.0,
                     dur_per_gb=4.0, mem_base=0.5, mem_per_gb=0.2,
                     default_limit_gb=4.0),
        FamilyRecipe("compact", shape="sawtooth", dur_base=30.0,
                     dur_per_gb=5.0, mem_base=0.8, mem_per_gb=0.3,
                     cycles=5.0, default_limit_gb=6.0),
    ]
    counts = _split_counts(n_tasks, (3, 2, 4, 1))
    wf = synthesize(recipes, counts, seed, name="workload_replay",
                    device=device)
    return dataclasses.replace(
        wf, parents=layered_parents(wf.B, seed=seed, layer_width=128,
                                    max_parents=2))
