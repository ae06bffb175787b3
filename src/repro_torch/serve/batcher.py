"""Micro-batch queue: arrival → bucket → dispatch → scatter.

The request front of :mod:`repro_torch.serve`: concurrent ``predict`` /
``tune_offset`` / ``evaluate`` calls land here as :class:`ServeRequest`
records and wait — at most ``max_wait_s`` — to be coalesced with other
requests into *buckets* (requests whose dispatch can share one batched
program, as decided by the server's ``key_fn``).  A flush fires when

* the oldest queued request has waited ``max_wait_s`` (the latency
  ceiling the operator buys batching with), or
* the queue reaches ``max_batch`` (saturation: arrivals outpace
  dispatch, so batches fill before the deadline — the regime the
  ``serve_saturation`` benchmark measures), or
* a caller forces it (``flush()`` / ``drain()``).

Backpressure is explicit: once ``max_queue`` requests are pending,
``submit`` raises :class:`Backpressure` instead of growing an unbounded
queue — the caller sheds load where it can still be cheap.

The batcher is **clock-injectable** (``clock=`` any monotonic float
source): tests and the saturation benchmark drive it on a virtual clock
(deterministic deadlines), while :meth:`MicroBatcher.start` runs the
same flush logic on a background thread against wall time for the live
``python -m repro_torch.serve`` front.  All shared state sits behind one lock;
dispatch itself runs *outside* the lock so slow programs never block
arrivals.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs import metrics as _met
from repro_torch.obs import trace as _obs

__all__ = ["Backpressure", "ServerClosed", "ServeFuture", "ServeRequest",
           "MicroBatcher"]


class Backpressure(RuntimeError):
    """The service queue is saturated (``max_queue`` pending requests);
    the request was rejected, not queued."""


class ServerClosed(RuntimeError):
    """The batcher/server was closed: the request was not (and will
    never be) dispatched.  Raised by ``submit`` after ``close()`` and
    set on every future still queued at close time — callers blocked in
    ``result()`` fail fast instead of hanging."""


class ServeFuture:
    """Minimal completion slot a request's response is scattered into.

    Cheaper than ``concurrent.futures.Future`` on the hot path: the
    waiter ``threading.Event`` is allocated lazily, so the common
    synchronous flows (manual pumping in tests/benchmarks, the
    ``batching=False`` per-request path) never touch thread machinery.
    """

    __slots__ = ("_value", "_exc", "_done", "_event")

    def __init__(self):
        self._value = None
        self._exc: Optional[BaseException] = None
        self._done = False
        self._event: Optional[threading.Event] = None

    @property
    def done(self) -> bool:
        return self._done

    def set_result(self, value) -> None:
        self._value = value
        self._done = True  # after _value: readers gate on _done
        if self._event is not None:
            self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True
        if self._event is not None:
            self._event.set()

    def result(self, timeout: Optional[float] = None):
        if not self._done:
            if self._event is None:
                self._event = threading.Event()
            if self._done:  # resolved between the check and the alloc
                self._event.set()
            if not self._event.wait(timeout):
                raise TimeoutError("serve request not completed in time")
        if self._exc is not None:
            raise self._exc
        return self._value


@dataclasses.dataclass(slots=True)
class ServeRequest:
    """One queued call: ``kind`` ∈ {predict, tune_offset, evaluate}."""

    kind: str
    tenant: str
    family: str
    payload: Any
    arrival: float
    future: ServeFuture = dataclasses.field(default_factory=ServeFuture)
    # Filled by the server's key_fn at submit time (snapshot resolution
    # happens once, not per flush) and read by the dispatch scatter.
    key: Any = None
    snapshot: Any = None


class MicroBatcher:
    """Bounded-wait coalescing queue in front of the dispatch layer.

    ``key_fn(request)`` assigns each request its bucket key (requests
    sharing a key are dispatched by ONE ``dispatch_fn(key, requests)``
    call); ``dispatch_fn`` must resolve every request's future.
    """

    def __init__(self, dispatch_fn: Callable[[Any, List[ServeRequest]], None],
                 key_fn: Callable[[ServeRequest], Any], *,
                 max_wait_s: float = 0.002, max_batch: int = 256,
                 max_queue: int = 4096,
                 clock: Callable[[], float] = None):
        import time
        if max_batch < 1 or max_queue < max_batch:
            raise ValueError("need max_batch >= 1 and max_queue >= max_batch")
        self._dispatch = dispatch_fn
        self._key = key_fn
        self.max_wait_s = float(max_wait_s)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: List[ServeRequest] = []
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._closed = False
        self.stats: Dict[str, int] = {
            "submitted": 0, "rejected": 0, "flushes": 0,
            "deadline_flushes": 0, "full_flushes": 0,
            "batches": 0, "dispatched": 0, "max_depth": 0,
        }

    # ------------------------------------------------------------- arrival
    def submit(self, req: ServeRequest) -> ServeFuture:
        """Queue one request; raises :class:`Backpressure` at saturation.

        Returns the request's future.  When the queue hits ``max_batch``
        the submitting caller flushes inline (saturation flush) — under a
        threaded front that keeps the worker a pure deadline timer.
        """
        req.key = self._key(req)
        with self._lock:
            if self._closed:
                raise ServerClosed(
                    f"serve front closed; request "
                    f"{req.kind}/{req.tenant}/{req.family} rejected")
            if len(self._queue) >= self.max_queue:
                self.stats["rejected"] += 1
                raise Backpressure(
                    f"serve queue saturated ({self.max_queue} pending); "
                    f"request {req.kind}/{req.tenant}/{req.family} rejected")
            self._queue.append(req)
            self.stats["submitted"] += 1
            depth = len(self._queue)
            if depth > self.stats["max_depth"]:
                self.stats["max_depth"] = depth
            full = depth >= self.max_batch
            if full or self._thread is not None:
                self._wake.notify()
            if _obs.enabled:
                _met.gauge("serve.queue_depth").set(depth)
        if full:
            self._flush(kind="full_flushes")
        return req.future

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def oldest_deadline(self) -> Optional[float]:
        """Clock time at which the oldest pending request must flush."""
        with self._lock:
            if not self._queue:
                return None
            return self._queue[0].arrival + self.max_wait_s

    # ------------------------------------------------------------ flushing
    def pump(self, now: Optional[float] = None) -> int:
        """Flush iff the deadline passed or the queue is full (manual
        clock driving).  Returns the number of requests dispatched."""
        now = self.clock() if now is None else now
        with self._lock:
            if not self._queue:
                return 0
            due = (now >= self._queue[0].arrival + self.max_wait_s
                   or len(self._queue) >= self.max_batch)
        return self._flush(kind="deadline_flushes") if due else 0

    def flush(self) -> int:
        """Force-dispatch everything pending (end-of-stream drain)."""
        return self._flush(kind="deadline_flushes")

    def _flush(self, kind: str) -> int:
        with self._lock:
            batch, self._queue = self._queue, []
            if not batch:
                return 0
            self.stats["flushes"] += 1
            self.stats[kind] += 1
        if _obs.enabled:
            _met.counter("serve.flushes").inc(cause=kind)
            _met.hist("serve.batch_size",
                      buckets=_met.COUNT_BUCKETS).observe(len(batch))
            now = self.clock()
            wait_h = _met.hist("serve.wait_s")
            for req in batch:
                wait_h.observe(now - req.arrival)
        buckets: Dict[Any, List[ServeRequest]] = {}
        for req in batch:  # insertion order: FIFO within a bucket
            buckets.setdefault(req.key, []).append(req)
        for key, reqs in buckets.items():
            if _obs.enabled:
                with _obs.span("serve.dispatch", n=len(reqs)):
                    self._dispatch_bucket(key, reqs)
            else:
                self._dispatch_bucket(key, reqs)
            self.stats["batches"] += 1
            self.stats["dispatched"] += len(reqs)
        return len(batch)

    def _dispatch_bucket(self, key, reqs: List[ServeRequest]) -> None:
        try:
            self._dispatch(key, reqs)
        except BaseException as exc:  # scatter failures, keep serving
            for r in reqs:
                if not r.future.done:
                    r.future.set_exception(exc)

    # ------------------------------------------------------- threaded front
    def start(self) -> None:
        """Run the deadline loop on a background thread (wall clock)."""
        if self._thread is not None:
            return
        self._running = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="repro-torch-serve-batcher")
        self._thread.start()

    def stop(self) -> None:
        """Stop the background thread, flushing whatever is pending."""
        if self._thread is None:
            return
        with self._lock:
            self._running = False
            self._wake.notify()
        self._thread.join()
        self._thread = None
        self.flush()

    def close(self) -> None:
        """Shut down without dispatching: stop the pump thread and fail
        every still-queued request with :class:`ServerClosed`.

        The counterpart to :meth:`stop` (which drains): ``close`` is the
        abandon-ship path — callers blocked in ``result()`` get the
        error immediately instead of hanging on a future no thread will
        ever resolve, and later ``submit`` calls are rejected.
        Idempotent.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._running = False
            self._wake.notify()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        with self._lock:
            pending, self._queue = self._queue, []
        for r in pending:
            if not r.future.done:
                r.future.set_exception(ServerClosed(
                    f"serve front closed with request "
                    f"{r.kind}/{r.tenant}/{r.family} still queued"))

    def _run(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._queue:
                    self._wake.wait()
                if not self._running:
                    return
                deadline = self._queue[0].arrival + self.max_wait_s
                wait = deadline - self.clock()
                if wait > 0:
                    self._wake.wait(wait)
                    continue  # re-evaluate: queue may have flushed/grown
            self._flush(kind="deadline_flushes")
