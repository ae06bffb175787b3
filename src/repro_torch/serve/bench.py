"""The ``serve_saturation`` harness: throughput, latency, cache discipline.

Three seeded, reproducible phases over a multi-tenant server fronting a
mixed method zoo (ks+, ks+auto, witt-p95, tovar-ppm — one per family):

* **throughput** — the same request tape through a batched server
  (micro-batches of up to ``max_batch``) and an unbatched one
  (``batching=False``: identical dispatch code, one request per bucket).
  Reports req/s for both, the speedup, and whether every batched plan is
  **bitwise equal** to its unbatched twin (the serve precision
  contract).  Prediction caching is off so every request is a real
  dispatch.
* **latency** — a hybrid discrete-event loop: a seeded open-loop Poisson
  arrival process and the batcher deadlines advance a *virtual* clock
  (deterministic coalescing), while each flush's *measured* wall-clock
  dispatch time advances it too (server-busy model).  p50/p99 are
  end-to-end: arrival → flush completion.  A flush ends with every
  future resolved to host numpy plans (predict dispatches compute on the
  host), so no device work is outstanding when its time is read.
* **discipline** — repeat-heavy traffic against the prediction cache
  (hit-rate), then a warm evaluate/tune/predict sweep pinned under
  ``dispatch_budget(compiles=0)`` with ``serve.dev_sync`` forbidden:
  after warmup the serving path builds and loads no kernel library and
  never re-uploads traces.

``python -m repro_torch.serve`` prints :func:`run_saturation`'s payload;
``chip_smoke.py`` runs it on the card.  Every server is built on
``device`` (None means the card).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.contracts import (DispatchBudgetError,
                                            dispatch_budget)
from repro_torch.serve.server import PredictionServer

__all__ = ["FAMILIES", "synth_family", "build_server", "request_tape",
           "measure_throughput", "measure_latency", "measure_discipline",
           "run_saturation"]

# One method per task family — the service fronts the whole registry,
# not one model (tovar-ppm is online=False: predict-only tenancy).
FAMILIES: Tuple[Tuple[str, str], ...] = (
    ("align", "ks+"),
    ("assemble", "ks+auto"),
    ("stats", "witt-p95"),
    ("report", "tovar-ppm"),
)


def synth_family(seed: int, n: int = 24, base: float = 2.0):
    """Seeded synthetic training executions: ramp-and-hold memory traces
    whose length and height scale with the input size."""
    rng = np.random.default_rng(seed)
    mems, dts, inputs = [], [], []
    for _ in range(n):
        size = float(rng.uniform(1.0, 5.0))
        length = int(24 + 6 * size)
        half = length // 2
        ramp = np.linspace(base, base + 1.2 * size, half)
        hold = np.full(length - half, base + 1.4 * size)
        mems.append(np.concatenate([ramp, hold]))
        dts.append(1.0)
        inputs.append(size)
    return mems, dts, inputs


def build_server(*, tenants: int = 8, batching: bool = True,
                 cache_predictions: bool = True,
                 max_wait_s: float = 0.002, max_batch: int = 256,
                 clock: Optional[Callable[[], float]] = None,
                 seed: int = 0, device=None) -> PredictionServer:
    """A server on ``device`` with ``tenants`` tenants all sharing the
    seeded zoo."""
    srv = PredictionServer(batching=batching, max_wait_s=max_wait_s,
                           max_batch=max_batch, clock=clock,
                           cache_predictions=cache_predictions,
                           device=device)
    for t in range(tenants):
        srv.add_tenant(f"tenant{t}")
    for i, (family, method) in enumerate(FAMILIES):
        mems, dts, inputs = synth_family(seed + i)
        srv.seed_family(family, method, mems, dts, inputs)
    return srv


def request_tape(n: int, tenants: int, seed: int = 0,
                 repeat_pool: Optional[int] = None
                 ) -> List[Tuple[str, str, float]]:
    """A seeded ``(tenant, family, input_gb)`` tape; ``repeat_pool``
    draws inputs from that many distinct values (cache-phase traffic)."""
    rng = np.random.default_rng(seed)
    pool = (rng.uniform(1.0, 5.0, repeat_pool)
            if repeat_pool is not None else None)
    tape = []
    for i in range(n):
        family = FAMILIES[int(rng.integers(len(FAMILIES)))][0]
        size = (float(pool[int(rng.integers(len(pool)))])
                if pool is not None else float(rng.uniform(1.0, 5.0)))
        tape.append((f"tenant{i % tenants}", family, size))
    return tape


def _run_tape(srv: PredictionServer, tape) -> list:
    futs = [srv.submit("predict", t, f, x) for t, f, x in tape]
    srv.drain()
    return [f.result(0) for f in futs]


def measure_throughput(*, n_requests: int = 1024, tenants: int = 8,
                       max_batch: int = 256, seed: int = 0, device=None
                       ) -> Dict[str, object]:
    """Batched vs unbatched req/s on one tape + the bitwise contract."""
    tape = request_tape(n_requests, tenants, seed=seed)
    warm = request_tape(2 * max_batch, tenants, seed=seed + 1)
    out: Dict[str, object] = {"n_requests": n_requests, "tenants": tenants}
    plans: Dict[bool, list] = {}
    for batching in (True, False):
        srv = build_server(tenants=tenants, batching=batching,
                           cache_predictions=False, max_batch=max_batch,
                           seed=seed, device=device)
        _run_tape(srv, warm)
        t0 = time.perf_counter()
        plans[batching] = _run_tape(srv, tape)
        dt = time.perf_counter() - t0
        mode = "batched" if batching else "unbatched"
        out[f"req_s_{mode}"] = n_requests / dt
        if batching:
            out["mean_batch"] = (srv._batcher.stats["dispatched"]
                                 / max(srv._batcher.stats["batches"], 1))
    out["speedup_x"] = out["req_s_batched"] / out["req_s_unbatched"]
    out["bitwise"] = all(
        np.array_equal(p.starts, q.starts) and np.array_equal(p.peaks,
                                                              q.peaks)
        for p, q in zip(plans[True], plans[False]))
    return out


def measure_latency(*, rate_rps: float = 2000.0, n_requests: int = 512,
                    tenants: int = 8, max_wait_s: float = 0.002,
                    seed: int = 1, device=None) -> Dict[str, float]:
    """Open-loop Poisson arrivals through the virtual-clock event loop."""
    vnow = [0.0]
    srv = build_server(tenants=tenants, batching=True,
                       cache_predictions=False, max_wait_s=max_wait_s,
                       max_batch=4096, clock=lambda: vnow[0], seed=seed,
                       device=device)
    _run_tape(srv, request_tape(128, tenants, seed=seed + 1))  # warm
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_rps, n_requests))
    tape = request_tape(n_requests, tenants, seed=seed + 2)
    pending: List[Tuple[float, object]] = []
    latencies: List[float] = []
    i = 0
    while i < n_requests or pending:
        next_arrival = arrivals[i] if i < n_requests else np.inf
        deadline = srv.oldest_deadline()
        deadline = np.inf if deadline is None else deadline
        if next_arrival <= deadline:
            vnow[0] = max(vnow[0], float(next_arrival))
            tenant, family, size = tape[i]
            pending.append((float(next_arrival),
                            srv.submit("predict", tenant, family, size)))
            i += 1
            continue
        vnow[0] = max(vnow[0], float(deadline))
        t0 = time.perf_counter()
        flushed = srv.pump(vnow[0])
        if flushed:
            vnow[0] += time.perf_counter() - t0  # server busy dispatching
            still = []
            for arrival, fut in pending:
                if fut.done:
                    latencies.append(vnow[0] - arrival)
                else:
                    still.append((arrival, fut))
            pending = still
    lat_ms = np.asarray(latencies) * 1e3
    return {"rate_rps": rate_rps,
            "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "served": len(latencies),
            "sim_elapsed_s": vnow[0]}


def measure_discipline(*, tenants: int = 8, n_requests: int = 512,
                       repeat_pool: int = 16, seed: int = 2, device=None
                       ) -> Dict[str, object]:
    """Cache hit-rate on repeat traffic + the warm zero-compile pin."""
    srv = build_server(tenants=tenants, batching=True,
                       cache_predictions=True, max_batch=64, seed=seed,
                       device=device)
    _run_tape(srv, request_tape(n_requests, tenants, seed=seed,
                                repeat_pool=repeat_pool))
    stats = srv.stats()
    hit_rate = stats["predictions"]["hit_rate"]
    # Warm the evaluate/tune path (the kernel library's build and load and
    # the trace uploads happen here)...
    for t in range(tenants):
        client = srv.client(f"tenant{t}")
        for family, _ in FAMILIES:
            client.evaluate(family)
    srv.client("tenant0").tune_offset("align")
    # ...then pin the warm path: no build, no load, no re-uploads.
    warm_ok = True
    try:
        with dispatch_budget(compiles=0, forbid=("serve.dev_sync",)):
            for t in range(tenants):
                client = srv.client(f"tenant{t}")
                for family, _ in FAMILIES:
                    client.evaluate(family)
            srv.client("tenant0").tune_offset("align")
            _run_tape(srv, request_tape(64, tenants, seed=seed + 3))
    except DispatchBudgetError:
        warm_ok = False
    return {"cache_hit_rate": float(hit_rate),
            "cache_hit_ok": bool(hit_rate > 0.5),
            "warm_zero_compiles": warm_ok,
            "distinct_shapes": stats["distinct_shapes"]}


def run_saturation(*, tenants: int = 8, n_requests: int = 2048,
                   rate_rps: float = 2000.0, seed: int = 0, device=None
                   ) -> Dict[str, object]:
    """The full ``serve_saturation`` benchmark payload (servers on
    ``device``; None means the card)."""
    thr = measure_throughput(n_requests=n_requests, tenants=tenants,
                             seed=seed, device=device)
    lat = measure_latency(rate_rps=rate_rps, n_requests=min(n_requests, 512),
                          tenants=tenants, seed=seed + 1, device=device)
    disc = measure_discipline(tenants=tenants, seed=seed + 2, device=device)
    return {"throughput": thr, "latency": lat, "discipline": disc}
