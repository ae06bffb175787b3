"""Timeline and metrics export: Chrome-trace JSON, JSONL, Prometheus.

Writers over the tracer ring (:func:`repro_torch.obs.trace.events`) and the
metrics registry (:data:`repro_torch.obs.metrics.REGISTRY`):

* :func:`chrome_trace` / :func:`write_chrome_trace` — the Chrome trace
  event format (JSON object with a ``traceEvents`` array), loadable by
  Perfetto / ``chrome://tracing``;
* :func:`write_jsonl` / :func:`read_events` — one event per line, the
  append-friendly log form; ``read_events`` round-trips both formats;
* :func:`prometheus_text` — text exposition of the metrics registry
  (counters, gauges, cumulative-bucket histograms; series are exported
  as their last point, full curves ride the JSON snapshot);
* :func:`summarize` — the per-tag time/dispatch/compile breakdown
  behind ``python -m repro_torch.obs summarize <trace>``; a compile is a
  kernel build or library load (``kernels.build``).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import trace as _trace

__all__ = ["chrome_trace", "write_chrome_trace", "write_jsonl",
           "read_events", "prometheus_text", "write_prometheus",
           "metrics_snapshot", "write_metrics_snapshot", "summarize"]


# Span keys carried in a Chrome event's ``args`` and folded back on read.
_SPAN_KEYS = ("counts", "id", "parent", "root")


def _events_or_ring(events: Optional[List[dict]]) -> List[dict]:
    return _trace.events() if events is None else list(events)


# ------------------------------------------------------------- chrome trace
def chrome_trace(events: Optional[List[dict]] = None) -> dict:
    """Chrome trace event format: ``{"traceEvents": [...]}``.

    Span dicts already carry the Chrome keys (``ph``/``name``/``ts``/
    ``dur``/``tid``); this adds the ``pid`` and folds the absorbed
    dispatch/compile attribution, the counts and the span's ``id`` /
    ``parent`` / ``root`` into ``args`` so Perfetto shows them in the span
    detail pane.
    """
    pid = os.getpid()
    out = []
    for ev in _events_or_ring(events):
        ce = {"ph": ev["ph"], "name": ev["name"], "ts": ev["ts"],
              "pid": pid, "tid": ev.get("tid", 0), "cat": "repro"}
        if ev["ph"] == "X":
            ce["dur"] = ev.get("dur", 0.0)
        if ev["ph"] == "i":
            ce["s"] = ev.get("s", "t")
        args = dict(ev.get("args") or {})
        if ev.get("dispatches"):
            args["dispatches"] = ev["dispatches"]
        if ev.get("compiles"):
            args["compiles"] = ev["compiles"]
            args["compile_us"] = ev.get("compile_us", 0.0)
        for key in _SPAN_KEYS:
            if key in ev:
                args[key] = ev[key]
        if args:
            ce["args"] = args
        out.append(ce)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       events: Optional[List[dict]] = None) -> int:
    doc = chrome_trace(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"])


# -------------------------------------------------------------------- jsonl
def write_jsonl(path: str, events: Optional[List[dict]] = None) -> int:
    evs = _events_or_ring(events)
    with open(path, "w", encoding="utf-8") as f:
        for ev in evs:
            f.write(json.dumps(ev) + "\n")
    return len(evs)


def read_events(path: str) -> List[dict]:
    """Load events back from either export format (the summarize CLI's
    round-trip): a Chrome-trace JSON object or a JSONL event log."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        # Multiple documents: a JSONL event log.
        return [json.loads(line) for line in text.splitlines() if line.strip()]
    if isinstance(doc, dict) and "traceEvents" in doc:
        # Chrome trace: fold args back into the ring shape.
        out = []
        for ce in doc["traceEvents"]:
            ev = dict(ce)
            args = dict(ev.pop("args", None) or {})
            if "dispatches" in args:
                ev["dispatches"] = args.pop("dispatches")
            if "compiles" in args:
                ev["compiles"] = args.pop("compiles")
                ev["compile_us"] = args.pop("compile_us", 0.0)
            for key in _SPAN_KEYS:
                if key in args:
                    ev[key] = args.pop(key)
            if args:
                ev["args"] = args
            out.append(ev)
        return out
    # A one-line JSONL file parses as a single JSON object.
    return [doc] if isinstance(doc, dict) else list(doc)


# --------------------------------------------------------------- prometheus
def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(f'{_prom_name(str(k))}="{v}"'
                    for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(registry: Optional[_metrics.Registry] = None) -> str:
    """Prometheus text exposition (version 0.0.4) of the registry."""
    registry = registry or _metrics.REGISTRY
    lines: List[str] = []
    for name, m in sorted(registry.metrics().items()):
        pname = _prom_name(name)
        snap = m.snapshot()
        if m.kind in ("counter", "gauge"):
            lines.append(f"# TYPE {pname} {m.kind}")
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            for row in snap["values"]:
                lines.append(
                    f"{pname}{_prom_labels(row['labels'])} {row['value']:g}")
        elif m.kind == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            if m.help:
                lines.append(f"# HELP {pname} {m.help}")
            for row in snap["values"]:
                for ub, c in zip(row["buckets"] + [float("inf")],
                                 row["cumulative"]):
                    le = "+Inf" if ub == float("inf") else f"{ub:g}"
                    lines.append(
                        f"{pname}_bucket"
                        f"{_prom_labels(row['labels'], {'le': le})} {c}")
                lines.append(
                    f"{pname}_sum{_prom_labels(row['labels'])} "
                    f"{row['sum']:g}")
                lines.append(
                    f"{pname}_count{_prom_labels(row['labels'])} "
                    f"{row['count']}")
        elif m.kind == "series":
            # Prometheus has no native series type; expose the last
            # point as a gauge (full curves live in the JSON snapshot).
            pts = snap["points"]
            if pts:
                lines.append(f"# TYPE {pname} gauge")
                t, v = pts[-1]
                lines.append(
                    f"{pname}{_prom_labels({'sim_t': f'{t:g}'})} {v:g}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str,
                     registry: Optional[_metrics.Registry] = None) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(prometheus_text(registry))


def metrics_snapshot(registry: Optional[_metrics.Registry] = None) -> dict:
    return (registry or _metrics.REGISTRY).snapshot()


def write_metrics_snapshot(path: str,
                           registry: Optional[_metrics.Registry] = None
                           ) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(metrics_snapshot(registry), f, indent=1)


# ---------------------------------------------------------------- summarize
def summarize(events: Optional[List[dict]] = None) -> str:
    """Per-tag breakdown: span time, dispatch counts, compiles.

    One row per span name (count / total / mean / max milliseconds plus
    the dispatch tags and compiles absorbed by those spans), then named
    instant events grouped by name, then one row per dispatch tag seen
    *outside* any span — the same accounting whether the events come
    from the live ring or a file round-trip.
    """
    evs = _events_or_ring(events)
    spans: Dict[str, dict] = defaultdict(
        lambda: {"n": 0, "total_us": 0.0, "max_us": 0.0,
                 "dispatches": defaultdict(int), "compiles": 0,
                 "compile_us": 0.0})
    loose: Dict[str, int] = defaultdict(int)
    instants: Dict[str, int] = defaultdict(int)
    compiles_loose = 0
    for ev in evs:
        if ev["ph"] == "X":
            row = spans[ev["name"]]
            row["n"] += 1
            dur = float(ev.get("dur", 0.0))
            row["total_us"] += dur
            row["max_us"] = max(row["max_us"], dur)
            for tag, n in (ev.get("dispatches") or {}).items():
                row["dispatches"][tag] += n
            row["compiles"] += int(ev.get("compiles", 0))
            row["compile_us"] += float(ev.get("compile_us", 0.0))
        elif ev["ph"] == "i":
            name = ev["name"]
            if name.startswith("dispatch:"):
                loose[name[len("dispatch:"):]] += 1
            elif name == _trace.COMPILE_EVENT:
                compiles_loose += 1
            else:
                instants[name] += 1

    head = (f"{'span':<28} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
            f"{'max_ms':>9} {'compiles':>8}  dispatches")
    lines = [head, "-" * len(head)]
    for name in sorted(spans, key=lambda n: -spans[n]["total_us"]):
        row = spans[name]
        disp = " ".join(f"{t}={c}" for t, c in sorted(
            row["dispatches"].items())) or "-"
        mean = row["total_us"] / row["n"] / 1e3
        lines.append(
            f"{name:<28} {row['n']:>7} {row['total_us'] / 1e3:>10.2f} "
            f"{mean:>9.3f} {row['max_us'] / 1e3:>9.2f} "
            f"{row['compiles']:>8}  {disp}")
    if not spans:
        lines.append("(no spans recorded)")
    if instants:
        lines.append("")
        lines.append("instants:")
        for name in sorted(instants):
            lines.append(f"  {name:<33} {instants[name]:>7}")
    if loose or compiles_loose:
        lines.append("")
        lines.append("outside any span:")
        for tag in sorted(loose):
            lines.append(f"  dispatch:{tag:<24} {loose[tag]:>7}")
        if compiles_loose:
            lines.append(f"  {_trace.COMPILE_EVENT:<33} {compiles_loose:>7}")
    n_instant = sum(1 for ev in evs if ev["ph"] == "i")
    lines.append("")
    lines.append(f"{len(evs)} events ({sum(r['n'] for r in spans.values())} "
                 f"spans, {n_instant} instants)")
    return "\n".join(lines)
