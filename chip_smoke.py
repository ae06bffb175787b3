"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device line: the card's name and power limit from ``nvidia-smi``, and
   the torch / CUDA versions;
2. build: ``nvcc`` builds the wastage kernels from ``src/`` (seconds);
3. kernel parity on the tests' sweeps: ``oom_probe`` and ``wastage_eval``
   on CUDA tensors against their plain PyTorch versions on the same
   tensors (``viol`` exact; floats rtol 1e-4 / atol 1e-2, the reduction
   order differs);
4. main path at paper size: ``evaluate_workflow`` over the eager and sarek
   workflows with all 9 methods on the card, then with ``device="cpu"``
   (the plain path); chosen k per family, retries and failures must be
   equal, GB·s within the reference's own tolerances; the ``oom_probe``
   launch count must have grown during the card runs;
5. main path at fleet scale: sarek with 2000 executions per family
   (20,000 executions) on the card: stage wall times, lanes, launches;
6. kernel parity at every ``(B, K, T, dt)`` that ``oom_probe`` was called
   with in phases 4 and 5 (every plan width the engine packs: 1 for the
   single-segment baselines, k, and ks+auto's widest candidate), on
   seeded engine-layout inputs (sentinel-padded slots, zero-length pad
   lanes), same checks as phase 3.  Then the kernels are timed (CUDA
   events, median after warm-up, L2 flushed) at phase 5's attempt-1 probe
   shapes, beside their byte bound.

The card's ``nvidia-smi`` line comes two lines before the end, then
``{"kernels": [...]}``; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
RTOL, ATOL = 1e-4, 1e-2       # kernel vs plain: reduction order only
SOURCE = "src/repro_torch/kernels/wastage/csrc/wastage.cu"
REPLACES = {"oom_probe": "src/repro/kernels/wastage/kernel.py:67",
            "wastage_eval": "src/repro/kernels/wastage/kernel.py:27"}


def log(*a):
    print(*a, flush=True)


# ------------------------------------------------------------------ phase 3
def _case(rng, B, T, K, dt, *, lo_len=1, sentinel=False, peaks=None):
    starts = np.sort(rng.uniform(0, T * 0.8 * dt, (B, K)), axis=1)
    starts[:, 0] = 0
    if sentinel and K > 2:
        starts[:, 2:] = 1e30
    if peaks is None:
        peaks = np.sort(rng.uniform(1, 6, (B, K)), axis=1)
    mems = np.abs(rng.normal(3, 1.5, (B, T)))
    lengths = rng.integers(lo_len, T, B)
    return starts, peaks, mems, lengths, dt


def parity_cases():
    """The sweeps of the kernel tests."""
    rng = np.random.default_rng(0)
    cases = []
    for B, T, K in [(8, 512, 4), (16, 700, 8), (3, 64, 1), (5, 96, 4)]:
        cases.append(("sweep", _case(rng, B, T, K, 1.0)))
    for dt in (0.5, 1.0, 2.5):
        cases.append((f"dt={dt}", _case(rng, 12, 700, 4, dt)))
    cases.append(("sentinel", _case(rng, 4, 128, 4, 1.0, sentinel=True)))
    for K in (1, 4, 8):
        c = _case(rng, 6, 96, K, 1.0)
        fat = np.full((6, K), float(c[2].max()) + 1.0)
        cases.append((f"all-fit K={K}", (c[0], fat) + c[2:]))
        cases.append((f"zero-plan K={K}", (c[0], np.zeros((6, K))) + c[2:]))
    c = _case(rng, 6, 256, 4, 1.0, peaks=rng.uniform(1, 10, (6, 4)))
    cases.append(("non-monotone", c))
    return [(name, to_cuda(*c[:4]) + (c[4],)) for name, c in cases]


def to_cuda(starts, peaks, mems, lengths):
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),  # noqa: E731
                                  device="cuda")
    return (f(starts), f(peaks), f(mems),
            torch.as_tensor(np.asarray(lengths, np.int32), device="cuda"))


class ProbeShapes:
    """While active, records the ``(B, K, T, dt)`` of every ``oom_probe``
    call (the engine looks the wrapper up in ``ops`` at each call).  It
    only records: launches and their counts stay the wrapper's own."""

    def __init__(self, ops):
        self.ops, self.seen = ops, set()

    def __enter__(self):
        orig = self.orig = self.ops.oom_probe

        def recorded(starts, peaks, mems, lengths, dt=1.0):
            self.seen.add((*starts.shape, mems.shape[1], float(dt)))
            return orig(starts, peaks, mems, lengths, dt=dt)
        self.ops.oom_probe = recorded
        return self

    def __exit__(self, *exc):
        self.ops.oom_probe = self.orig


def main_path_cases(shapes, seed=0):
    """Seeded inputs in the engine's layout at each recorded shape: sorted
    starts from 0 with sentinel starts past each lane's segment count (its
    last peak replicated), monotone peaks, zero-length pad lanes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for B, K, T, dt in sorted(shapes):
        u = lambda *sz: torch.rand(*sz, generator=g, device="cuda")  # noqa: E731
        starts = torch.sort(u(B, K) * (0.8 * T * dt), dim=1).values
        starts[:, 0] = 0.0
        peaks = torch.sort(1.0 + 5.0 * u(B, K), dim=1).values
        nseg = torch.randint(1, K + 1, (B,), generator=g, device="cuda")
        pad = torch.arange(K, device="cuda")[None, :] >= nseg[:, None]
        starts = torch.where(pad, 1e30, starts).contiguous()
        last = torch.gather(peaks, 1, (nseg - 1)[:, None])
        peaks = torch.where(pad, last, peaks).contiguous()
        # noisy ramps of per-lane height: some lanes fit, others cross
        # the step allocation early or late
        ramp = 0.5 + torch.arange(T, device="cuda") / T
        noise = 1.0 + 0.1 * torch.randn(B, T, generator=g, device="cuda")
        mems = ((1.0 + 4.0 * u(B, 1)) * ramp * noise.abs()).contiguous()
        lengths = torch.randint(1, T + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        lengths[B - B // 8:] = 0  # the engine's pow2 lane padding
        yield (f"main {B}x{T} K={K} dt={dt}",
               (starts, peaks, mems, lengths, dt))


def check_kernels(cases, err):
    """Hold both kernels against their plain versions on ``cases``,
    folding the largest float error per kernel into ``err``."""
    from repro_torch.kernels.wastage import ops, ref
    for name, (s, p, m, n, dt) in cases:
        viol, ws, wk = ops.oom_probe(s, p, m, n, dt=dt)
        vr, wsr, wkr = ref.oom_probe(s, p, m, n, dt)
        we = ops.wastage_eval(s, p, m, n, dt=dt)
        wer = ref.wastage_eval(s, p, m, n, dt)
        torch.cuda.synchronize()
        if not torch.equal(viol, vr):
            raise AssertionError(f"oom_probe viol differs on case {name}")
        for op, a, b in (("oom_probe", ws, wsr), ("oom_probe", wk, wkr),
                         ("wastage_eval", we, wer)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL,
                                       msg=f"{op} on case {name}")
            err[op] = max(err[op], float((a - b).abs().max()))


# ------------------------------------------------------------------ timing
def time_ms(fn, reps=25, warmup=3):
    """Median device ms of ``fn`` per call (CUDA events).

    Before each timed call the 50 MB L2 is flushed (the main path meets each
    bucket cold) and the device is kept busy with a sleep while the host
    enqueues the call, so the events bracket device time, not the Python
    wrapper's launch latency.
    """
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def probe_groups(res, wf, seed, train_frac):
    """The attempt-1 probe groups of the ks+ job, as the engine builds
    them: the test split bucketed on the card, plans sliced per bucket."""
    from repro_torch.core.fleet import (PAD_START, bucket_traces,
                                        concat_packed, packed_predict)
    _, test = wf.split(seed, train_frac, 1.0)
    fams = [f for f in wf.families if test[f]]
    flat = [e for f in fams for e in test[f]]
    traces = bucket_traces([e.mem for e in flat], device="cuda")
    starts, peaks, _ = concat_packed([
        packed_predict(res.fitted[f]["ks+"], [e.input_gb for e in test[f]])
        for f in fams])
    groups = []
    for b in traces.buckets:
        Bp = b.dmems.shape[0]
        bs = np.full((Bp, starts.shape[1]), PAD_START, np.float32)
        bp = np.ones((Bp, peaks.shape[1]), np.float32)
        bs[:len(b.idx)], bp[:len(b.idx)] = starts[b.idx], peaks[b.idx]
        s, p, _, _ = to_cuda(bs, bp, b.mems[:1], b.lengths[:1])
        groups.append((s, p, b.dmems, b.dlengths))
    return groups


def kernel_timings(groups, launches):
    from repro_torch.kernels.wastage import ops, ref
    out = []
    for name, out_words in (("oom_probe", 3), ("wastage_eval", 1)):
        kern = getattr(ops, name)
        plain = getattr(ref, name)
        ms, plain_ms = [], []
        nbytes = nops = 0
        for s, p, m, n in groups:
            ms.append(time_ms(lambda: kern(s, p, m, n, dt=1.0)))
            plain_ms.append(time_ms(lambda: plain(s, p, m, n, 1.0)))
            B, K = s.shape
            valid = int(n.sum())  # the kernel reads valid samples only
            nbytes += valid * 4 + B * (2 * K + 1) * 4 + B * out_words * 4
            # per valid sample: K interval tests (2 compares, 1 and, 1 add)
            # plus the grid multiply, max, subtract and accumulate
            nops += valid * (4 * K + 4) + (valid if name == "oom_probe" else 0)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "ms": sum(ms), "plain_ms": sum(plain_ms),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bytes": nbytes, "ops": nops,
            "timed": "attempt-1 probe of the ks+ job over the fleet-scale "
                     "test split: one launch per length bucket, summed",
            "groups": [list(g[2].shape) for g in groups],
            "group_ms": ms, "group_plain_ms": plain_ms})
    return out


# ------------------------------------------------------------------ phase 4
def compare_runs(card, cpu, label):
    for m in card.methods:
        a, b = card.methods[m], cpu.methods[m]
        if (a.retries, a.failures) != (b.retries, b.failures):
            raise AssertionError(
                f"{label}/{m}: card retries/failures {a.retries}/{a.failures}"
                f" vs cpu {b.retries}/{b.failures}")
        np.testing.assert_allclose(a.total_gbs, b.total_gbs, rtol=1e-4,
                                   err_msg=f"{label}/{m}")
        for fam in a.per_family_gbs:
            np.testing.assert_allclose(
                a.per_family_gbs[fam], b.per_family_gbs[fam], rtol=1e-4,
                atol=1e-2, err_msg=f"{label}/{m}/{fam}")
        if not all(math.isfinite(v) for v in a.per_family_gbs.values()):
            raise AssertionError(f"{label}/{m}: non-finite wastage")
    for fam in card.fitted:
        ka = card.fitted[fam]["ks+auto"].chosen_k
        kb = cpu.fitted[fam]["ks+auto"].chosen_k
        if ka != kb:
            raise AssertionError(f"{label}/{fam}: chosen k {ka} vs {kb}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.wastage import build, ops
    from repro_torch.sched import evaluate_workflow
    from repro_torch.traces import eager, sarek

    # 1. device line
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} x {torch.cuda.device_count()}")

    # 2. build
    path, secs = build.build()
    log(f"phase 2: built {os.path.relpath(path, ROOT)} in {secs:.2f} s")

    # 3. kernel parity on the tests' sweeps
    err = {"oom_probe": 0.0, "wastage_eval": 0.0}
    cases = parity_cases()
    check_kernels(cases, err)
    log(f"phase 3: kernel == plain on {len(cases)} cases, max abs err {err}")

    # 4. main path at paper size, card vs the plain path on the CPU
    kw = dict(seed=0, train_frac=0.5, k=4, machine_memory=128.0)
    shapes = ProbeShapes(ops)
    ops.reset_launches()
    with shapes:
        card = {wf.name: evaluate_workflow(wf, device="cuda", **kw)
                for wf in (eager(), sarek())}
    launches = dict(ops.LAUNCHES)
    if launches["oom_probe"] <= 0:
        raise AssertionError("main path launched no oom_probe kernel")
    for name, res in card.items():
        log(f"phase 4: {name} on the card, stage seconds {res.seconds}")
        cpu = evaluate_workflow(
            eager() if name == "eager" else sarek(), device="cpu", **kw)
        compare_runs(res, cpu, name)
        ks = {f: m["ks+auto"].chosen_k for f, m in res.fitted.items()}
        log(f"phase 4: {name} card == cpu; chosen k {ks}")
    log(f"phase 4: main-path launches {launches}")

    # 5. fleet scale on the card
    big = sarek(instances_per_family=2000)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with shapes:
        res = evaluate_workflow(big, device="cuda", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    big_launches = dict(ops.LAUNCHES)
    n_test = sum(len(v) for v in big.split(0, 0.5, 1.0)[1].values())
    for m, r in res.methods.items():
        if not (math.isfinite(r.total_gbs) and r.total_gbs > 0):
            raise AssertionError(f"fleet scale {m}: wastage {r.total_gbs}")
    base = min(r.total_gbs for m, r in res.methods.items()
               if not m.startswith("ks+"))
    log(f"phase 5: sarek(2000) {n_test} test executions x "
        f"{len(res.methods)} methods = {n_test * len(res.methods)} lanes; "
        f"stage seconds {res.seconds}; wall {wall:.3f} s; launches "
        f"{big_launches}; wastage reduction vs best baseline: ks+ "
        f"{(base - res.methods['ks+'].total_gbs) / base:.4f}, ks+auto "
        f"{(base - res.methods['ks+auto'].total_gbs) / base:.4f}")

    # 6. kernel parity at every shape the main path probed
    check_kernels(main_path_cases(shapes.seen), err)
    widths = sorted({K for _, K, _, _ in shapes.seen})
    log(f"phase 6: kernel == plain at all {len(shapes.seen)} (B, K, T, dt) "
        f"the main path probed (K in {widths}), max abs err {err}")

    # kernel times at this run's attempt-1 probe groups (ks+ plans)
    groups = probe_groups(res, big, 0, 0.5)
    kernels = kernel_timings(groups, launches)
    for k in kernels:
        k["max_abs_err"] = err[k["name"]]
    log(smi)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
