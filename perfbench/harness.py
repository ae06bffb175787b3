"""One run of one cell: set-up, the measured window, the check.

The cell is found in ``BENCHMARK.json`` at the checkout's root by name; its
configuration, traffic mix and limits are files of their own under
``perfbench/`` named after it, the mix's ``kind`` names its driver in
``kinds/``, the configuration's family its reference in ``reference/``, and
each per-layer metric its reader in ``metrics/``.  A driver module gives
``setup(ctx)``, ``window(ctx, state, clock, tracer)``, ``end_to_end(ctx,
window)``, ``release(state, window)`` (frees the program, returns what the
check needs) and ``check(ctx, kept)`` (the compared numbers).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from perfbench import trace as T
from perfbench.reference.common import no_tf32

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")   # top-level module names


@dataclasses.dataclass
class Context:
    cell: str
    seed: int
    seconds: float
    device: torch.device
    spec: dict          # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # workloads/<cell>.json "limits"
    cfg: object         # the program's config object
    reference: object   # reference/<family>.py
    kind: object        # kinds/<kind>.py


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def context(root: Path, cell: str, seed: int, seconds: float, device,
            model: dict | None = None, traffic: dict | None = None
            ) -> Context:
    """The cell's context; ``model`` and ``traffic`` replace entries of the
    configuration's ``model`` and of the mix (the tests' small sizes)."""
    from perfbench.program import model_config
    man = manifest(root)
    w = cell_entry(man, cell)
    conf = next(c for c in man["configs"] if c["name"] == w["config"])
    spec = read_json(root / conf["file"])
    spec["model"].update(model or {})
    bench = root / "perfbench"
    mix = dict(read_json(bench / "traffic" / f"{w['traffic']}.json"),
               **(traffic or {}))
    limits = read_json(bench / "workloads" / f"{cell}.json")["limits"]
    return Context(
        cell=cell, seed=seed, seconds=seconds, device=torch.device(device),
        spec=spec, traffic=mix, limits=limits, cfg=model_config(spec),
        reference=importlib.import_module(
            f"perfbench.reference.{spec['model']['family']}"),
        kind=importlib.import_module(f"perfbench.kinds.{mix['kind']}"))


def reader(root: Path, name: str):
    """The ``read(record)`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reports(entry: dict, cell: str) -> bool:
    """Whether ``cell`` reports the metric ``entry``: the cells its
    ``workloads`` lists (an end-to-end metric without the key: every
    cell)."""
    return cell in entry.get("workloads", [cell])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: Path, cell: str, seed: int, seconds: float, trace: bool,
        started: float, device="cuda", chips: int = 1, **overrides):
    """One run; returns ``(result, checks)``: the result line's object and
    ``{number: (value, limit)}``.  ``overrides``: see :func:`context`."""
    no_tf32()
    man = manifest(root)
    ctx = context(root, cell, seed, seconds, device, **overrides)
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    clock = time.perf_counter
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    st = ctx.kind.setup(ctx)
    sync()
    setup_s = clock() - started
    tracer = T.Tracer() if trace else None
    if tracer:
        tracer.start()
    w = ctx.kind.window(ctx, st, clock, tracer)
    events = tracer.stop() if tracer else None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kept = ctx.kind.release(st, w)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    if not trace:
        values = dict(ctx.kind.end_to_end(ctx, w), setup_s=setup_s)
        for m in man["end_to_end"]:
            if reports(m, cell):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": w["attempted"],
              "failed": w["failed"], "metrics": metrics, "device": dev}
    if trace:
        rec = {"events": events, "busy_s": T.busy_s(events),
               "window_s": w["t1"] - w["t0"], "spans": w["spans"],
               "shapes": w["shapes"], "model": ctx.spec["model"],
               "traffic": ctx.traffic}
        for m in man["per_layer"]:
            if reports(m, cell):
                value = reader(root, m["name"])(rec)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        result["breakdown"] = T.breakdown(events)

    numbers = ctx.kind.check(ctx, kept)   # those with a limit are compared
    checks = {k: (numbers[k], lim) for k, lim in ctx.limits.items()}
    result["correct"] = w["failed"] == 0 and all(
        v <= lim for v, lim in checks.values())
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
