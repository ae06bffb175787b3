"""repro_torch.obs — engine-wide tracing, metrics, and timeline export.

Built on the dispatch-tag seam (:mod:`repro_torch.analysis.contracts`):
spans absorb ``record_dispatch`` tags, the kernel builds and library
loads of :mod:`repro_torch.kernels.build` and the counts of :func:`count`
(the serving path's weight casts), the metrics registry collects
serve/drain/engine counters, and :mod:`repro_torch.obs.export` writes
Chrome-trace/Perfetto JSON, JSONL logs, and Prometheus text.  Everything
is off by default; the disabled hot path is a single ``trace.enabled``
attribute check and tracing never perturbs placements (see
``tests/test_torch_obs.py``).

Usage::

    from repro_torch import obs

    with obs.tracing():
        sim.run(jobs, retry, trace=True)
    obs.write_chrome_trace("trace.perfetto.json")
    print(obs.summarize())
"""

from repro_torch.obs import export, metrics, trace
from repro_torch.obs.export import (chrome_trace, metrics_snapshot,
                                    prometheus_text, read_events, summarize,
                                    write_chrome_trace, write_jsonl,
                                    write_metrics_snapshot, write_prometheus)
from repro_torch.obs.metrics import (REGISTRY, Counter, Gauge, Histogram,
                                     Registry, Series, counter, gauge, hist,
                                     series)
from repro_torch.obs.trace import (Span, clear, clock_offset_us, count,
                                   disable, dropped, enable, events,
                                   instant, span, tracing)

__all__ = [
    "trace", "metrics", "export",
    # trace
    "enable", "disable", "tracing", "span", "instant", "count", "events",
    "clear", "dropped", "clock_offset_us", "Span",
    # metrics
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram", "Series",
    "counter", "gauge", "hist", "series",
    # export
    "chrome_trace", "write_chrome_trace", "write_jsonl", "read_events",
    "prometheus_text", "write_prometheus", "metrics_snapshot",
    "write_metrics_snapshot", "summarize",
]
