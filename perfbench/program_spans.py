"""The program's own spans on the device trace's clock, and the device's
idle time put down to them.

A traced window that reads the program's spans makes four calls:

* :func:`start` clears and enables the program's tracer
  (``repro_torch.obs.trace``) before the profiler starts;
* :func:`anchor`, while the profiler runs, once after it starts and once
  before it stops: on a quiet device it launches ``ANCHORS`` one-element
  device operations, each inside a ``clock.anchor`` span, a host
  synchronise after each;
* :func:`stop`, after the profiler stops, disables the tracer and takes the
  profiler's events (``perfbench.trace.Tracer.stop``'s).  It finds each
  anchor's operation, alone in the quiet stretch around its group, and
  takes a group's offset from trace time to the events' clock as the least
  of its anchors' (operation start − span start): the launch that reached
  the device soonest.  Each profiler session converts device times with an
  offset of its own, so the mapping is read inside the session; between
  the groups it is drawn linearly, which follows a drift of the two clocks
  over the window.  It returns a :class:`Program`: the spans on the events'
  clock, one dict a span with ``name``, ``start``, ``end``, ``id``,
  ``parent``, ``root`` (the outermost span's id: a serving step's spans
  share their step's) and ``counts``; the events without the anchors'
  operations; and the groups' offsets.

A program whose tracer has no clock offset (one older than its spans)
gives none.  ``harness.run`` does not call these yet: a record that holds
the spans under ``"program"`` beside its ``"events"`` is what the
functions below read.

:func:`idle_by_span` walks the device's idle gaps (between the union of
its operations' intervals) and puts each idle microsecond down to the
innermost program span open at that time, so no microsecond counts
twice; idle time while no span is open goes nowhere.
"""

from __future__ import annotations

import bisect
import heapq
import time
from typing import NamedTuple

RING = 1 << 22      # events; a traced window holds well under a million
DECODE_STEP = "model.decode_step"
ANCHOR = "clock.anchor"
ANCHORS = 5             # device operations a call of anchor() launches
QUIET_S = 0.004         # device idle before and after a group of anchors
MATCH_US = 2000.0       # how far the coarse Unix mapping may be off


class Program(NamedTuple):
    spans: list         # the program's spans on the events' clock
    events: list        # the profiler's events, the anchors' taken out
    offsets: list       # [(trace us, offset us)]: one a group of anchors


def start():
    """Clear and enable the program's tracer for the window.  Returns the
    tracer module, or None where the program's spans cannot be put on the
    device's clock."""
    from repro_torch.obs import trace
    if not hasattr(trace, "clock_offset_us"):
        return None
    trace.enable(ring=RING)
    trace.clear()
    return trace


def anchor(trace) -> None:
    """Launch a group of anchors on a quiet device (call it while the
    profiler runs).  Takes about ``2 * QUIET_S`` of host time."""
    if trace is None:
        return
    import torch
    buf = torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    time.sleep(QUIET_S)
    for _ in range(ANCHORS):
        with trace.span(ANCHOR):
            buf.zero_()
        torch.cuda.synchronize()
    time.sleep(QUIET_S)


def offsets(marks, events, coarse: float) -> tuple:
    """``([(ts, offset)], used)``: for each group of ``ANCHORS`` anchor
    spans ``marks`` (ring events, in time order), the trace time of its
    middle and its offset from trace time to the clock of ``events``
    (sorted by start); and the indices in ``events`` of the anchors'
    operations.  ``coarse`` is the tracer's Unix offset, which finds them.
    Raises unless each group's stretch holds exactly its operations."""
    marks = sorted(marks, key=lambda e: e["ts"])
    if not marks or len(marks) % ANCHORS:
        raise RuntimeError(f"the program's trace holds {len(marks)} clock "
                           f"anchors, not groups of {ANCHORS}")
    starts = [e[1] for e in events]
    fit, used = [], []
    for g in range(0, len(marks), ANCHORS):
        grp = marks[g:g + ANCHORS]
        lo = bisect.bisect_left(starts, grp[0]["ts"] + coarse - MATCH_US)
        hi = bisect.bisect_right(
            starts, grp[-1]["ts"] + grp[-1]["dur"] + coarse + MATCH_US)
        if hi - lo != ANCHORS:
            raise RuntimeError(f"clock anchors: {hi - lo} device operations "
                               f"in the stretch of a group of {ANCHORS}")
        off = min(starts[i] - m["ts"] for i, m in zip(range(lo, hi), grp))
        fit.append((sum(m["ts"] for m in grp) / ANCHORS, off))
        used.extend(range(lo, hi))
    return fit, used


def _offset_at(fit, t: float) -> float:
    """The offset at trace time ``t``: linear between the groups, the
    nearest group's outside them."""
    if t <= fit[0][0]:
        return fit[0][1]
    for (t0, o0), (t1, o1) in zip(fit, fit[1:]):
        if t <= t1:
            return o0 + (o1 - o0) * (t - t0) / (t1 - t0)
    return fit[-1][1]


def stop(trace, events=None) -> Program:
    """Disable the tracer; its spans on the clock of ``events`` (the
    profiler's, in start order), put there by the anchors, and ``events``
    without the anchors' operations.  Without ``events`` (no device) the
    spans are put on the Unix clock by the tracer's own offset.  Raises if
    the ring dropped any event (the spans would be partial) or the anchors
    are not found."""
    if trace is None:
        return Program([], list(events or ()), [])
    trace.disable()
    if trace.dropped():
        raise RuntimeError(f"the program's trace ring dropped "
                           f"{trace.dropped()} events")
    ring = [e for e in trace.events() if e["ph"] == "X"]
    trace.clear()
    marks = [e for e in ring if e["name"] == ANCHOR]
    if events is None:
        fit, kept = [(0.0, trace.clock_offset_us())], []
    else:
        fit, used = offsets(marks, events, trace.clock_offset_us())
        drop = set(used)
        kept = [e for i, e in enumerate(events) if i not in drop]
    spans = []
    for e in ring:
        if e["name"] == ANCHOR:
            continue
        t0, t1 = e["ts"], e["ts"] + e["dur"]
        spans.append({"name": e["name"], "start": t0 + _offset_at(fit, t0),
                      "end": t1 + _offset_at(fit, t1), "id": e["id"],
                      "parent": e["parent"], "root": e["root"],
                      "counts": e.get("counts", {})})
    return Program(spans, kept, fit)


def idle_gaps(events) -> list:
    """``[(start, end)]`` of the device's idle gaps: the holes in the union
    of the operations' intervals, between the first and the last."""
    gaps, reach = [], None
    for _, start, end, _ in sorted(events, key=lambda e: e[1]):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps


def innermost(spans) -> list:
    """``[(start, end, id)]``: the time line cut where the innermost open
    span (the deepest; of equal depth, the latest started) changes, in
    time order; stretches with no span open are left out."""
    opens = sorted(spans, key=lambda s: (s["start"], -s["end"]))
    depth: dict = {}
    for s in opens:     # a parent starts before its children
        depth[s["id"]] = depth.get(s["parent"], -1) + 1
    cuts = sorted({t for s in spans for t in (s["start"], s["end"])})
    out, heap, i = [], [], 0
    for t0, t1 in zip(cuts, cuts[1:]):
        while i < len(opens) and opens[i]["start"] <= t0:
            s = opens[i]
            heapq.heappush(heap, (-depth[s["id"]], -s["start"], s["id"],
                                  s["end"]))
            i += 1
        while heap and heap[0][3] <= t0:    # closed: pop once on top
            heapq.heappop(heap)
        if not heap:
            continue
        sid = heap[0][2]
        if out and out[-1][2] == sid and out[-1][1] == t0:
            out[-1] = (out[-1][0], t1, sid)
        else:
            out.append((t0, t1, sid))
    return out


def idle_by_span(events, spans) -> dict:
    """``{span id: idle microseconds}``: each idle microsecond of the device
    put down to the innermost program span open at that time."""
    segs = innermost(spans)
    out: dict = {}
    j = 0
    for a, b in idle_gaps(events):
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                out[segs[k][2]] = out.get(segs[k][2], 0.0) + hi - lo
            k += 1
    return out


def steps(rec) -> set:
    """Ids of the decode steps' root spans in ``rec``."""
    return {s["id"] for s in rec.get("program") or ()
            if s["name"] == DECODE_STEP}


def idle_ms_per_step(rec, pick):
    """Device idle ms a decode step while the innermost open span was one
    ``pick(name)`` accepts, under a decode step's root; None without
    decode steps."""
    roots = steps(rec)
    if not roots:
        return None
    spans = rec["program"]
    idle = idle_by_span(rec["events"], spans)
    us = sum(idle.get(s["id"], 0.0) for s in spans
             if s["root"] in roots and pick(s["name"]))
    return us / 1e3 / len(roots)
