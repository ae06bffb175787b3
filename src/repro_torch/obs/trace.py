"""Low-overhead span tracer built on the dispatch-tag seam.

One module-global tracer (mirroring :mod:`repro_torch.analysis.contracts`'
module-global counters): :data:`enabled` is the master switch, and the
**disabled path is a single attribute check** — instrumented hot paths
are written as ::

    if _obs.enabled:
        with _obs.span("admission.drain") as sp:
            out = self._drain(now, lanes, select)
            sp.add(placed=len(out))
    ...

so a replay with tracing off allocates nothing and calls nothing.
Tracing only ever *observes* — ``perf_counter_ns`` timestamps, counter
reads, host values the caller already holds; never a host read of a
device tensor or a synchronise — so traced and untraced replays are
bitwise-identical on placements, retries and evictions (pinned by
``tests/test_torch_obs.py``).  Span times are host times: on the card
they cover the device work only where the spanned code ends in a host
read.

Three event sources feed one bounded ring buffer:

* **spans** — :func:`span` context managers on a thread-local stack;
  each close appends one complete ("X") event with its duration and
  whatever dispatch/compile activity it enclosed;
* **dispatch tags** — :func:`enable` installs a hook into
  :func:`repro_torch.analysis.contracts.record_dispatch`, so every
  self-reported device-program launch (``admission.drain``,
  ``serve.batch``, ...) lands as an instant event *and* is attributed
  to the innermost open span on its thread;
* **compiles** — :func:`enable` also installs a hook into
  :func:`repro_torch.analysis.contracts.record_compile`, which
  :mod:`repro_torch.kernels.build` calls on every ``nvcc`` build and
  library load: it becomes a per-span compile count, or a loose
  ``kernels.build`` instant when no span is open.

Export/summary live in :mod:`repro_torch.obs.export`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

__all__ = ["enabled", "enable", "disable", "tracing", "span", "instant",
           "events", "clear", "Span", "DEFAULT_RING", "COMPILE_EVENT"]

DEFAULT_RING = 65536
# Name of a compile instant recorded outside any span.
COMPILE_EVENT = "kernels.build"

# The master switch.  Hot paths read this ONE module attribute and do
# nothing else when it is False.
enabled: bool = False

_ring: Deque[dict] = deque(maxlen=DEFAULT_RING)
_tls = threading.local()
_epoch_ns = time.perf_counter_ns()  # trace-relative timestamp origin


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _now_us() -> float:
    return (time.perf_counter_ns() - _epoch_ns) / 1e3


class Span:
    """One open span: name + start time + absorbed dispatch/compile
    activity.  Appended to the ring as a complete event on exit."""

    __slots__ = ("name", "args", "tid", "t0", "dispatches",
                 "compiles", "compile_us")

    def __init__(self, name: str, args: Optional[dict]):
        self.name = name
        self.args = args
        self.tid = threading.get_ident()
        self.t0 = 0.0
        self.dispatches: Optional[Dict[str, int]] = None
        self.compiles = 0
        self.compile_us = 0.0

    def add(self, **args) -> "Span":
        """Attach result-side attributes (e.g. ``placed=n``) post-entry."""
        if self.args is None:
            self.args = dict(args)
        else:
            self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        _stack().append(self)
        self.t0 = _now_us()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _now_us()
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        ev = {"ph": "X", "name": self.name, "ts": self.t0,
              "dur": t1 - self.t0, "tid": self.tid}
        if self.args:
            ev["args"] = self.args
        if self.dispatches:
            ev["dispatches"] = self.dispatches
        if self.compiles:
            ev["compiles"] = self.compiles
            ev["compile_us"] = self.compile_us
        _ring.append(ev)
        return False


class _NoopSpan:
    """Shared do-nothing span for defensive unguarded calls while
    tracing is off."""

    __slots__ = ()

    def add(self, **args) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, **args):
    """Open a span; use as a context manager.  No-op while disabled."""
    if not enabled:
        return _NOOP
    return Span(name, args or None)


def instant(name: str, **args) -> None:
    """Record one instant event.  No-op while disabled."""
    if not enabled:
        return
    ev = {"ph": "i", "name": name, "ts": _now_us(),
          "tid": threading.get_ident(), "s": "t"}
    if args:
        ev["args"] = args
    _ring.append(ev)


# ------------------------------------------------------------------ bridges
def _on_dispatch(tag: str, n: int) -> None:
    """contracts.record_dispatch hook: attribute to the innermost open
    span, or record a loose instant event when no span is open."""
    if not enabled:
        return
    st = _stack()
    if st:
        sp = st[-1]
        if sp.dispatches is None:
            sp.dispatches = {}
        sp.dispatches[tag] = sp.dispatches.get(tag, 0) + n
    else:
        _ring.append({"ph": "i", "name": f"dispatch:{tag}",
                      "ts": _now_us(), "tid": threading.get_ident(),
                      "s": "t"})


def _on_compile(source: str, event: str, seconds: float) -> None:
    """contracts.record_compile hook: a kernel build or library load."""
    if not enabled:
        return
    us = seconds * 1e6
    st = _stack()
    if st:
        sp = st[-1]
        sp.compiles += 1
        sp.compile_us += us
    else:
        _ring.append({"ph": "i", "name": COMPILE_EVENT, "ts": _now_us(),
                      "tid": threading.get_ident(), "s": "t",
                      "args": {"duration_us": us, "source": source,
                               "event": event}})


# ---------------------------------------------------------------- lifecycle
def enable(ring: Optional[int] = None) -> None:
    """Turn tracing on: install the dispatch and compile hooks,
    optionally resizing the ring (which clears it)."""
    global enabled, _ring
    from repro_torch.analysis import contracts
    if ring is not None and ring != _ring.maxlen:
        _ring = deque(maxlen=int(ring))
    contracts._obs_dispatch_hook = _on_dispatch
    contracts._obs_compile_hook = _on_compile
    enabled = True


def disable() -> None:
    """Turn tracing off (the ring's contents stay readable)."""
    global enabled
    from repro_torch.analysis import contracts
    enabled = False
    contracts._obs_dispatch_hook = None
    contracts._obs_compile_hook = None


@contextlib.contextmanager
def tracing(ring: Optional[int] = None):
    """Scope-enable tracing; restores the previous on/off state on exit
    (events recorded inside stay in the ring for export)."""
    was = enabled
    enable(ring=ring)
    try:
        yield
    finally:
        if not was:
            disable()


def events() -> List[dict]:
    """Snapshot of the ring, oldest first."""
    return list(_ring)


def clear() -> None:
    _ring.clear()
