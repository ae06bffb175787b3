"""The program's spans as a traced window collects them: the tracer
switched on and off around the window, spans put on the device trace's
clock by the anchors (found alone in their quiet stretch, the least offset
of a group, drawn linearly between groups), a dropped event or a missing
anchor refused; the device's idle time put down to the innermost span, on
a synthetic record with gaps planted in known spans; and, on the card, an
idle gap planted inside a span put down to that span in every planting
(the clocks agree).

  python -m pytest -q -m cuda perfbench/tests   (from the repo root, on the card)
"""

import time

import pytest
import torch

from perfbench import program_spans
from perfbench import trace as T


@pytest.fixture
def tracer():
    from repro_torch.obs import trace
    yield trace
    trace.disable()
    trace._ring = type(trace._ring)(maxlen=trace.DEFAULT_RING)
    trace.clear()


def test_start_and_stop_collect_spans_on_the_unix_clock(tracer):
    prog = program_spans.start()
    assert prog is tracer and tracer.enabled
    wall_us = time.time_ns() / 1e3
    with tracer.span("model.decode_step", B=2):
        with tracer.span("attention"):
            tracer.count("weights.cast_bytes", 16)
    got = program_spans.stop(prog)
    spans = got.spans
    assert got.events == [] and len(got.offsets) == 1
    assert not tracer.enabled and tracer.events() == []
    by = {s["name"]: s for s in spans}
    step, attn = by["model.decode_step"], by["attention"]
    assert abs(step["start"] - wall_us) < 1000.0
    assert step["start"] <= attn["start"] <= attn["end"] <= step["end"]
    assert attn["parent"] == attn["root"] == step["id"] == step["root"]
    assert attn["counts"] == {"weights.cast_bytes": 16} and step["counts"] == {}


def test_a_dropped_event_refuses_the_run(tracer, monkeypatch):
    monkeypatch.setattr(program_spans, "RING", 4)
    prog = program_spans.start()
    for _ in range(5):
        with tracer.span("moe.route"):
            pass
    with pytest.raises(RuntimeError, match="dropped 1 events"):
        program_spans.stop(prog)


def test_a_program_without_the_clock_offset_gives_no_spans(tracer,
                                                           monkeypatch):
    monkeypatch.delattr(tracer, "clock_offset_us")
    prog = program_spans.start()
    assert prog is None and not tracer.enabled
    assert program_spans.stop(prog) == ([], [], [])
    assert program_spans.stop(prog, [("k", 1.0, 2.0, "decode")]).events == [
        ("k", 1.0, 2.0, "decode")]


def anchored_window(tracer, deltas, latency=(900.0, 12.0, 30.0, 9.0, 20.0)):
    """The tracer's ring after a window with a group of anchors at each end
    and a ``model.decode_step`` span between, and device events as a
    profiler would give them: the device clock ``deltas[g]`` us ahead of
    the Unix one at group ``g``, each anchor's operation ``latency`` after
    its span opened, and two of the window's operations."""
    prog = program_spans.start()
    marks = []
    for g in range(2):
        for _ in range(program_spans.ANCHORS):
            with tracer.span(program_spans.ANCHOR) as sp:
                pass
            marks.append(sp.t0)
            time.sleep(0.002)       # the synchronise after each
        if g == 0:
            time.sleep(program_spans.QUIET_S)
            with tracer.span("model.decode_step"):
                time.sleep(0.001)
            time.sleep(program_spans.QUIET_S)
    unix = tracer.clock_offset_us()
    step = next(e for e in tracer.events() if e["name"] == "model.decode_step")
    ev = []
    for i, t in enumerate(marks):
        g = i // program_spans.ANCHORS
        at = t + unix + deltas[g] + latency[i % program_spans.ANCHORS]
        ev.append(("fill", at, at + 2.0, "before"))
    for t in (step["ts"] + 100.0, step["ts"] + 800.0):
        ev.append(("k", t + unix, t + unix + 50.0, "decode"))
    ev.sort(key=lambda e: e[1])
    return prog, step, ev, unix, marks


def test_anchors_put_spans_on_the_device_clock(tracer):
    """A group's offset is its quickest anchor's; between the groups the
    offset is drawn linearly, so a drift of the clocks is followed; the
    anchors' operations leave the events."""
    prog, step, ev, unix, marks = anchored_window(tracer, (300.0, 500.0))
    got = program_spans.stop(prog, ev)
    assert [e[0] for e in got.events] == ["k", "k"]
    assert [o for _, o in got.offsets] == pytest.approx(
        [unix + 309.0, unix + 509.0], abs=0.5)
    n = program_spans.ANCHORS
    assert got.offsets[0][0] == pytest.approx(sum(marks[:n]) / n)
    (sp,) = got.spans
    t0, t1 = got.offsets[0][0], got.offsets[1][0]
    frac = (step["ts"] - t0) / (t1 - t0)
    assert 0.0 < frac < 1.0
    # Unix microseconds as floats keep a quarter of a microsecond
    assert sp["start"] == pytest.approx(
        step["ts"] + unix + 309.0 + 200.0 * frac, abs=0.5)
    assert sp["end"] - sp["start"] == pytest.approx(
        step["dur"] + 200.0 * step["dur"] / (t1 - t0), abs=0.5)


def test_anchors_not_found_alone_refuse_the_run(tracer):
    prog, _, ev, unix, marks = anchored_window(tracer, (0.0, 0.0))
    extra = marks[0] + unix + 50.0
    with pytest.raises(RuntimeError, match="6 device operations"):
        program_spans.stop(prog, sorted(ev + [("x", extra, extra + 1.0,
                                                 "before")],
                                        key=lambda e: e[1]))
    prog, _, ev, _, _ = anchored_window(tracer, (0.0, 0.0))
    with pytest.raises(RuntimeError, match="4 device operations"):
        program_spans.stop(prog, ev[1:])
    prog = program_spans.start()
    with pytest.raises(RuntimeError, match="holds 0 clock anchors"):
        program_spans.stop(prog, ev)


def span(sid, name, start, end, parent=None, root=None, **counts):
    return {"name": name, "start": start, "end": end, "id": sid,
            "parent": parent, "root": sid if root is None else root,
            "counts": counts}


# idle gaps planted in the device's time line (us), and what holds each
GAPS = [(15, 35),     # in attention, around a nested span at 20-30
        (55, 70),     # across moe.route and moe.experts
        (85, 95),     # in the decode step's own code
        (120, 130),   # between steps: no span open
        (212, 218),   # attention, second step
        (250, 270),   # moe.combine to 260, then the step's own code
        (405, 409)]   # in the prefill's attention
END = 450


def program_record():
    """Two decode steps and a prefill, with their spans, over device
    operations that leave the ``GAPS`` idle (two of them overlap, so the
    idle time is the union's)."""
    ev, t = [], 0.0
    for a, b in GAPS:
        ev.append(("k", t, a, "decode"))
        t = b
    ev += [("k", t, END, "decode"), ("overlap", 1.0, 14.0, "decode")]
    ev.sort(key=lambda e: e[1])
    prog = [span(3, "launch", 20, 30, parent=2, root=1),
            span(2, "attention", 10, 40, parent=1, root=1),
            span(4, "moe.route", 50, 60, parent=1, root=1),
            span(5, "moe.experts", 60, 80, parent=1, root=1),
            span(1, "model.decode_step", 0, 100),
            span(11, "attention", 210, 230, parent=10, root=10),
            span(12, "moe.combine", 240, 260, parent=10, root=10),
            span(10, "model.decode_step", 200, 320),
            span(21, "attention", 400, 410, parent=20, root=20),
            span(20, "model.prefill", 390, 440)]
    return {"events": ev, "program": prog}


def test_idle_goes_to_the_innermost_span_once():
    rec = program_record()
    assert program_spans.idle_gaps(rec["events"]) == GAPS
    idle = program_spans.idle_by_span(rec["events"], rec["program"])
    assert idle == pytest.approx({3: 10, 2: 10, 4: 5, 5: 10, 1: 10, 11: 6,
                                  12: 10, 10: 10, 21: 4})
    # nothing counted twice; the gap between the steps goes nowhere
    assert sum(idle.values()) == pytest.approx(
        sum(b - a for a, b in GAPS) - 10)


def test_idle_a_decode_step_by_span_name():
    rec = program_record()
    assert program_spans.steps(rec) == {1, 10}
    # attention: 5 + 5 around the nested span, 6 in the second step; the
    # prefill's attention is not a decode step's
    assert program_spans.idle_ms_per_step(
        rec, lambda n: n == "attention") == pytest.approx((10 + 6) / 2 / 1e3)
    # moe: 5 in route + 10 in experts, 10 in combine
    assert program_spans.idle_ms_per_step(
        rec, lambda n: n.startswith("moe.")) == pytest.approx(
            (15 + 10) / 2 / 1e3)


def test_no_decode_step_reads_nothing():
    rec = program_record()
    for prog in (None, [], [s for s in rec["program"]
                            if s["name"] != "model.decode_step"]):
        rec["program"] = prog
        assert program_spans.idle_ms_per_step(rec, bool) is None, prog
    del rec["program"]
    assert program_spans.idle_ms_per_step(rec, bool) is None


@pytest.mark.cuda
def test_a_planted_gap_goes_to_its_span(tracer):
    """Under the harness's profiler with the program's tracer on, each
    planting its own profiler session: anchors, a kernel, a span that
    sleeps 5 ms on the host and launches a kernel as it closes, anchors.
    In every planting the device's gap between the two kernels lies in
    that span, its ends within 0.2 ms of the span's, and the clocks agree
    to 0.2 ms by causality: a kernel starts after the host began its
    launch and ends before the host's synchronise returns, each read on
    its own clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the harness's profiler traces it")
    x = torch.randn(1 << 22, device="cuda")
    x * 2.0 + 1.0                       # load both kernels before timing
    rows = []
    for _ in range(PLANTINGS):
        prog = program_spans.start()
        prof = T.Tracer()
        prof.start()
        program_spans.anchor(prog)
        with tracer.span("launch"):
            y = x * 2.0
        with tracer.span("planted"):
            time.sleep(0.005)
            y = y + 1.0
        with tracer.span("sync"):
            torch.cuda.synchronize()
        program_spans.anchor(prog)
        got = program_spans.stop(prog, prof.stop())
        by = {s["name"]: s for s in got.spans}
        k1, k2 = got.events
        sp = by["planted"]
        assert k2[1] - k1[2] > 4500.0
        idle = program_spans.idle_by_span(got.events, got.spans)
        assert idle[sp["id"]] == pytest.approx(
            min(sp["end"], k2[1]) - max(sp["start"], k1[2]), abs=0.5)
        rows.append({"head": k1[2] - sp["start"], "tail": k2[1] - sp["end"],
                     "early": by["launch"]["start"] - k1[1],
                     "late": k2[2] - by["sync"]["end"],
                     "drift": got.offsets[1][1] - got.offsets[0][1]})
    # head: the first kernel's end after the span opened; tail: the second
    # kernel's start after the span closed (the card's start after 5 ms
    # idle); early > 0: a kernel read as starting before its launch began;
    # late > 0: ending after the synchronise returned; drift: the offset's
    # change from the first group of anchors to the last
    for key in rows[0]:
        print(f"planted gap, {key} (us):", [round(r[key], 2) for r in rows])
    for r in rows:
        assert max(abs(r["head"]), abs(r["tail"]), r["early"], r["late"],
                   abs(r["drift"])) <= 200.0, r


PLANTINGS = 12
