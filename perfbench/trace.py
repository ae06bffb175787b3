"""The traced run's record: device operations from ``torch.profiler`` and
the harness's own phases.

The profiler traces the card only (CUPTI activity, no host operators), so
its cost on the host stays small.  Each phase of the window (a prefill,
a decode step) starts with a marker: a one-thread sleep
kernel of a few cycles, which the device runs in stream order.  The phase
of every device operation is the label of the last marker before it, so
the readers of ``metrics/`` can split device time by phase without host
timestamps.  No trace file is written: the record holds the operations'
names, starts and ends, which the readers reduce.
"""

from __future__ import annotations

import torch

MARK = "spin_kernel"     # the kernel of torch.cuda._sleep
MARK_CYCLES = 64


class Tracer:
    def __init__(self):
        self.labels: list[str] = []
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def mark(self, label: str) -> None:
        """Start a phase named ``label`` (on the device's stream)."""
        self.labels.append(label)
        torch.cuda._sleep(MARK_CYCLES)

    def stop(self) -> list:
        """``[(name, start_us, end_us, phase)]`` of the window's device
        operations in start order, markers left out."""
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start = e.start_ns() / 1e3
            raw.append((start, start + e.duration_ns() / 1e3, e.name()))
        self._prof = None
        raw.sort()
        out, phase, i = [], "before", 0
        for start, end, name in raw:
            if MARK in name:
                phase = self.labels[i] if i < len(self.labels) else "after"
                i += 1
                continue
            out.append((name, start, end, phase))
        if i != len(self.labels):
            raise RuntimeError(f"the trace holds {i} phase markers, the "
                               f"window started {len(self.labels)} phases")
        return out


def busy_s(events) -> float:
    """Seconds in which an operation ran on the device (the union of the
    operations' intervals)."""
    total, reach = 0.0, None
    for _, start, end, _ in events:
        if reach is None or start >= reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e6


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by what the host was doing: the phase the gap lies in, or
    ``a->b`` for a gap that spans the start of a new phase."""
    by_op: dict = {}
    for name, start, end, _ in events:
        short = name.removeprefix("void ").split("(")[0].split("<")[0][:80]
        by_op[short] = by_op.get(short, 0.0) + (end - start) / 1e6
    gaps: dict = {}
    reach, phase = None, None
    for _, start, end, ph in events:
        if reach is not None and start > reach:
            label = ph if ph == phase else f"{phase}->{ph}"
            gaps[label] = gaps.get(label, 0.0) + (start - reach) / 1e6
        reach = end if reach is None else max(reach, end)
        phase = ph
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
    return {"device_ops": [[k, v] for k, v in rank(by_op)],
            "idle_gaps": [[k, v] for k, v in rank(gaps)]}
