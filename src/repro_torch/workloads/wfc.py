"""wfcommons / WorkflowHub instance import (and export).

`wfcommons <https://wfcommons.org>`_ publishes real workflow executions as
JSON *instances* (the WfFormat): a task graph plus per-task measurements.
This module turns such an instance into the same :class:`WorkflowTrace` +
DAG representation the synthetic generator emits, so imported workloads
flow through every consumer unchanged — DAG-aware :class:`ClusterSim`
replay, ``evaluate_workflow``, offset tuning, the fleet engine.

Two layouts are understood:

* **WfFormat >= 1.4** — tasks under ``workflow.specification.tasks``
  (``id``, ``name``, ``parents`` as id lists), measurements under
  ``workflow.execution.tasks`` (``runtimeInSeconds``,
  ``memoryInBytes``);
* **legacy (<= 1.3)** — tasks inline under ``workflow.tasks`` (or
  ``workflow.jobs``) with ``runtime`` seconds, ``memory`` bytes and
  ``parents`` as name lists.

wfcommons instances carry *peak* memory only, so each imported task gets a
noise-free plateau trace at its peak over its measured runtime (the
honest reconstruction — any richer time structure would be invented),
materialized on the requested device by the generator's trace synthesis
(:func:`repro_torch.workloads.generate.materialize_traces`).

Schema validation is loud: missing sections, duplicate ids, unknown
parent references, self-parents and dependency cycles all raise
``ValueError`` naming the offending task ids.  ``export_instance`` writes
a WfFormat-1.4-shaped document back out; import(export(x)) round-trips
the task graph and measurements exactly (pinned in
``tests/test_torch_workloads.py``).
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.workloads.generate import (
    _SHAPE_ID,
    WorkflowTrace,
    materialize_traces,
)

__all__ = ["load_instance", "import_instance", "export_instance",
           "validate_dag_ids"]

_GIB = float(2 ** 30)


def validate_dag_ids(ids: Sequence, parents: Sequence[Sequence],
                     kind: str = "task") -> None:
    """Validate a task graph given as (id, parent-ids) lists — loudly.

    Raises ``ValueError`` naming the offending ids for duplicates,
    unknown parent references, self-parents, and dependency cycles
    (Kahn's algorithm residue).  The single validator behind both the
    wfcommons importer (string ids) and :class:`ClusterSim`'s submit-time
    DAG check (integer jids, ``kind="job"``).
    """
    seen, dups = set(), set()
    for i in ids:
        (dups if i in seen else seen).add(i)
    if dups:
        raise ValueError(f"duplicate {kind} ids: {sorted(dups)}")
    index = {tid: k for k, tid in enumerate(ids)}
    selfdep = sorted(tid for tid, ps in zip(ids, parents) if tid in ps)
    if selfdep:
        raise ValueError(f"{kind}s cannot be their own parent: {selfdep}")
    unknown = {tid: sorted(p for p in ps if p not in index)
               for tid, ps in zip(ids, parents)}
    unknown = {t: m for t, m in unknown.items() if m}
    if unknown:
        first = next(iter(unknown))
        raise ValueError(
            f"{kind} {first!r} references unknown parent ids: "
            f"{unknown[first]} ({len(unknown)} {kind}(s) affected)")
    # Kahn: whatever never reaches in-degree 0 sits on a cycle.
    pending = np.zeros(len(ids), np.int64)
    children: List[List[int]] = [[] for _ in ids]
    for k, ps in enumerate(parents):
        for p in dict.fromkeys(ps):
            children[index[p]].append(k)
            pending[k] += 1
    stack = [k for k in range(len(ids)) if pending[k] == 0]
    reached = 0
    while stack:
        k = stack.pop()
        reached += 1
        for c in children[k]:
            pending[c] -= 1
            if pending[c] == 0:
                stack.append(c)
    if reached != len(ids):
        cyc = sorted(ids[k] for k in range(len(ids)) if pending[k] > 0)
        raise ValueError(f"dependency cycle among task ids: {cyc}")


_TRAIL = re.compile(r"[_\-.]?\d+$")


def _category(name: str) -> str:
    """Task family from a task name: strip the trailing instance number
    (``blast_00000042`` -> ``blast``), the wfcommons naming convention."""
    return _TRAIL.sub("", name) or name


def _parse_tasks(doc: dict) -> List[dict]:
    """Normalize either WfFormat layout into
    ``{id, name, parents, runtime, memory_gb}`` records."""
    wf = doc.get("workflow")
    if not isinstance(wf, dict):
        raise ValueError(
            "not a wfcommons instance: missing 'workflow' object")
    out = []
    spec = wf.get("specification")
    if isinstance(spec, dict) and "tasks" in spec:
        execs = {t.get("id"): t
                 for t in wf.get("execution", {}).get("tasks", [])}
        missing = []
        for t in spec["tasks"]:
            tid = t.get("id")
            if tid is None:
                raise ValueError(
                    f"specification task without an 'id': {t.get('name')!r}")
            ex = execs.get(tid, {})
            if "runtimeInSeconds" not in ex or "memoryInBytes" not in ex:
                missing.append(str(tid))
                continue
            out.append(dict(
                id=str(tid), name=str(t.get("name", tid)),
                parents=[str(p) for p in t.get("parents", [])],
                runtime=float(ex["runtimeInSeconds"]),
                memory_gb=float(ex["memoryInBytes"]) / _GIB))
        if missing:
            raise ValueError(
                "tasks without runtime/memory measurements in "
                f"'workflow.execution.tasks': {sorted(missing)} — traces "
                "cannot be reconstructed from the specification alone")
        return out
    tasks = wf.get("tasks", wf.get("jobs"))
    if not isinstance(tasks, list):
        raise ValueError(
            "not a wfcommons instance: expected 'workflow.specification."
            "tasks' (WfFormat >= 1.4) or 'workflow.tasks' (legacy)")
    missing = []
    for t in tasks:
        tid = t.get("id", t.get("name"))
        if tid is None:
            raise ValueError(f"task without an 'id' or 'name': {t!r}")
        if "runtime" not in t or "memory" not in t:
            missing.append(str(tid))
            continue
        out.append(dict(
            id=str(tid), name=str(t.get("name", tid)),
            parents=[str(p) for p in t.get("parents", [])],
            runtime=float(t["runtime"]),
            memory_gb=float(t["memory"]) / _GIB))
    if missing:
        raise ValueError(
            f"tasks without 'runtime'/'memory' fields: {sorted(missing)}")
    # Legacy parents reference task *names*; translate names -> ids where
    # the parent is not already a known id (id == name is the common case).
    ids = {t["id"] for t in out}
    by_name = {t["name"]: t["id"] for t in out}
    for t in out:
        t["parents"] = [p if p in ids else by_name.get(p, p)
                        for p in t["parents"]]
    return out


def import_instance(doc: dict, *, dt: float = 1.0,
                    name: Optional[str] = None,
                    device=None) -> WorkflowTrace:
    """A validated :class:`WorkflowTrace` from a wfcommons instance dict.

    Peak-only measurements become noise-free plateau traces at
    ``memoryInBytes`` over ``runtimeInSeconds`` (sampled every ``dt``
    seconds), packed straight into fleet lanes on ``device`` (None means
    the card); families come from the task-name category (trailing
    instance numbers stripped).
    """
    tasks = _parse_tasks(doc)
    ids = [t["id"] for t in tasks]
    validate_dag_ids(ids, [t["parents"] for t in tasks])
    index = {tid: k for k, tid in enumerate(ids)}
    B = len(tasks)
    if B == 0:
        raise ValueError("instance contains no tasks")
    lengths = np.maximum(
        np.ceil(np.asarray([t["runtime"] for t in tasks]) / dt - 1e-9),
        1.0).astype(np.int64)
    level = np.maximum(
        np.asarray([t["memory_gb"] for t in tasks], np.float64), 1e-3)
    batch = materialize_traces(
        np.full((B,), _SHAPE_ID["plateau"], np.float32),
        level.astype(np.float32), lengths,
        np.zeros((B, 3), np.float32), np.zeros((B,), np.float32), seed=0,
        device=device)
    families = [_category(t["name"]) for t in tasks]
    return WorkflowTrace(
        name=(name if name is not None
              else str(doc.get("name", "wfcommons"))),
        task_ids=ids, families=families,
        input_gb=level.copy(),     # proxy: peak memory tracks input size
        dts=np.full((B,), float(dt)),
        lengths=lengths,
        parents=tuple(tuple(index[p] for p in t["parents"])
                      for t in tasks),
        batch=batch,
        default_limits={f: 8.0 for f in families})


def load_instance(path, *, dt: float = 1.0,
                  name: Optional[str] = None,
                  device=None) -> WorkflowTrace:
    """:func:`import_instance` on a JSON file path."""
    with open(path) as f:
        return import_instance(json.load(f), dt=dt, name=name, device=device)


def export_instance(trace: WorkflowTrace) -> dict:
    """A WfFormat-1.4-shaped instance dict for ``trace``.

    Emits the task graph (specification) and per-task runtime / peak
    memory (execution); time structure beyond the peak is not part of the
    format, so ``import_instance(export_instance(t))`` reconstructs
    plateau traces — graph, runtimes and peaks round-trip exactly.
    """
    children: Dict[int, List[int]] = {i: [] for i in range(trace.B)}
    for i, ps in enumerate(trace.parents):
        for p in ps:
            children[p].append(i)
    peaks = trace.peaks()
    spec_tasks, exec_tasks = [], []
    for i in range(trace.B):
        tid = trace.task_ids[i]
        spec_tasks.append({
            "id": tid,
            # wfcommons naming convention: category + instance number —
            # re-import recovers the task family from it.
            "name": f"{trace.families[i]}_{i:08d}",
            "parents": [trace.task_ids[p] for p in trace.parents[i]],
            "children": [trace.task_ids[c] for c in children[i]],
        })
        exec_tasks.append({
            "id": tid,
            "runtimeInSeconds": float(trace.lengths[i] * trace.dts[i]),
            "memoryInBytes": float(peaks[i] * _GIB),
        })
    return {
        "name": trace.name,
        "schemaVersion": "1.4",
        "workflow": {
            "specification": {"tasks": spec_tasks},
            "execution": {"tasks": exec_tasks},
        },
    }
