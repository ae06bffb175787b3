"""Seeded cases and tolerances that the port's CPU parity tests and its
card tests (``cuda``-marked) share, so each case exists once.

This module imports neither ``jax`` nor the reference package ``repro``:
the card tests import it on a machine that has the port and not the JAX
reference (``python -m pytest -q -m cuda tests/``).
"""

import numpy as np
import torch

from repro_torch.core import RetrySpec
from repro_torch.core.envelope import PAD_START, alloc_at_packed
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.wastage import ops as wastage_ops
from repro_torch.sched import Node

# ------------------------------------------------------ the wastage probes
# viol exact; w_succ / w_kill within the reference tests' tolerance
# (float32 sums in another order)
PROBE_TOL = dict(rtol=1e-4, atol=1e-2)


def _probe_case(seed, B, T, k, dt=1.0, *, sentinel=False, monotone=True):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, T * 0.8 * dt, (B, k)), axis=1)
    starts[:, 0] = 0
    if sentinel:
        starts[:, 2:] = 1e30
    peaks = rng.uniform(1, 6, (B, k))
    if monotone:
        peaks = np.sort(peaks, axis=1)
    mems = np.abs(rng.normal(3, 1.5, (B, T)))
    lengths = rng.integers(1, T, B)
    return (starts.astype(np.float32), peaks.astype(np.float32),
            mems.astype(np.float32), lengths.astype(np.int32))


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _probe_cases():
    """``{name: (starts, peaks, mems, lengths, dt)}``: the CPU tests' sweep
    (``B, T, k``, three dt, sentinel slots, all-fit and zero plans at
    k = 1, 4 and 8, plans that step down, starts that decrease) and rows
    of T = 97, whose samples the kernel loads one at a time."""
    cases = {}
    for seed, (B, T, k, dt) in enumerate([
            (8, 512, 4, 1.0), (16, 700, 8, 2.5), (3, 64, 1, 0.5),
            (16, 700, 8, 1.0), (3, 64, 1, 1.0), (5, 96, 4, 1.0),
            (5, 97, 4, 1.0)]):
        cases[f"B{B} T{T} k{k} dt{dt}"] = _probe_case(seed, B, T, k, dt) \
            + (dt,)
    for dt in (0.5, 1.0, 2.5):
        cases[f"T700 dt{dt}"] = _probe_case(7, 12, 700, 4, dt) + (dt,)
    cases["sentinel"] = _probe_case(8, 4, 128, 4, sentinel=True) + (1.0,)
    for k in (1, 4, 8):
        starts, _, mems, lengths = _probe_case(9 + k, 6, 96, k)
        fat = np.full((6, k), float(mems.max()) + 1.0, np.float32)
        cases[f"all-fit k{k}"] = (starts, fat, mems, lengths, 1.0)
        cases[f"zero-plan k{k}"] = (starts, np.zeros((6, k), np.float32),
                                    mems, lengths, 1.0)
    cases["non-monotone"] = _probe_case(12, 6, 256, 4, monotone=False) \
        + (1.0,)
    starts, peaks, mems, lengths = _probe_case(15, 6, 256, 4)
    cases["decreasing starts"] = (np.ascontiguousarray(starts[:, ::-1] * 0.5),
                                  peaks, mems, lengths, 1.0)
    return cases


# -------------------------------------------------------- the fleet engine
F = np.float32
WTOL = dict(rtol=1e-4)  # the reference's test_fleet: sums in another order


def _traces(seed, n=40, max_len=300):
    rng = np.random.default_rng(seed)
    mems = []
    for _ in range(n):
        L = int(rng.integers(1, max_len))
        m = np.full(L, rng.uniform(0.5, 4.0))
        m[int(rng.integers(0, L)):] += rng.uniform(0.0, 6.0)
        mems.append(np.abs(m + rng.normal(0, 0.05, L)))
    return mems


def _plans(seed, mems, K=4, nonmono=False):
    rng = np.random.default_rng(seed + 1)
    B = len(mems)
    starts = np.sort(rng.uniform(0, 1, (B, K)), axis=1) \
        * np.asarray([max(len(m), 1) for m in mems])[:, None]
    starts[:, 0] = 0.0
    peaks = rng.uniform(0.3, 1.2, (B, K)) \
        * np.asarray([m.max() if len(m) else 1.0 for m in mems])[:, None]
    if not nonmono:
        peaks = np.sort(peaks, axis=1)
    nseg = rng.integers(1, K + 1, B).astype(np.int32)
    real = np.arange(K)[None, :] < nseg[:, None]
    last = np.take_along_axis(peaks, (nseg - 1)[:, None], axis=1)
    starts = np.where(real, starts, PAD_START)
    peaks = np.where(real, peaks, last)
    return starts.astype(np.float32), peaks.astype(np.float32), nseg


def _edge(dt, n=24):
    """Second starts on the grid i * dt or one ulp either side, over
    traces that step up at sample i: fit or kill hangs on the exact bound."""
    mems, starts = [], []
    for i in range(n):
        n0 = 5 + 7 * i
        mems.append(np.concatenate([np.full(n0, 1.0), np.full(40, 3.0)]))
        s = F(n0) * F(dt)
        s = (s, np.nextafter(s, F(0)), np.nextafter(s, F(np.inf)))[i % 3]
        starts.append([0.0, s])
    starts = np.asarray(starts, np.float32)
    return mems, (starts, np.tile(F([2.0, 4.0]), (n, 1)),
                  np.full(n, 2, np.int32))


def _groups(seed=31):
    rng = np.random.default_rng(seed)
    out = []
    for B, K, T in [(5, 4, 128), (3, 1, 96), (7, 8, 701)]:
        mems = torch.from_numpy(np.abs(rng.normal(3, 1, (B + 2, T))).astype(F))
        lengths = torch.from_numpy(rng.integers(0, T, B + 2).astype(np.int32))
        starts = np.sort(rng.uniform(0, T, (B, K)), axis=1).astype(F)
        starts[:, 0] = 0
        peaks = np.sort(rng.uniform(1, 6, (B, K)), axis=1).astype(F)
        out.append(wastage_ops.Group(
            starts, peaks, mems, lengths, nseg=np.full(B, K, np.int32),
            summem=torch.zeros(B + 2),
            bump_lanes=rng.uniform(0, 1, B).astype(F) if K == 8 else None,
            kind="ksplus", margin=0.1, bump=0.2))
    return out


ENGINE_KINDS = ["ksplus", "kseg-selective", "kseg-partial", "double",
                "max-machine", "none"]


def _sweep():
    """``{name: (jobs, mems, dt, machine_memory, max_attempts)}``: every
    retry kind, a per-lane bump with NaN entries, unsatisfiable lanes,
    max_attempts exhaustion, K = 1 and 32, zero-length lanes, ulp-edge
    starts at three dt and many jobs over many buckets."""
    cases = {}
    for kind in ENGINE_KINDS:
        mems = _traces(41)
        cases[f"kind {kind}"] = (
            [(_plans(41, mems, nonmono=kind.startswith("kseg")),
              RetrySpec(kind))], mems, 1.0, 12.0, 25)
    mems = _traces(42)
    bump = np.random.default_rng(42).uniform(0.05, 0.6, len(mems))
    bump[::5] = np.nan
    cases["per-lane bump"] = ([(_plans(42, mems), RetrySpec("ksplus"),
                                bump)], mems, 1.0, 16.0, 25)
    mems = _traces(43)
    mems[0], mems[3] = np.full(20, 50.0), np.zeros(0)
    cases["unsatisfiable"] = ([(_plans(43, mems, K=32), RetrySpec("double")),
                               (_plans(44, mems, K=1),
                                RetrySpec("kseg-partial"))],
                              mems, 1.0, 16.0, 6)
    mems = [np.full(8, 10.0)] * 3
    cases["max_attempts"] = ([((np.zeros((3, 1), F), np.full((3, 1), 2.0, F),
                                np.ones(3, np.int32)), RetrySpec("none"))],
                             mems, 1.0, 16.0, 5)
    for K, kind in ((1, "ksplus"), (32, "ksplus"), (32, "kseg-partial")):
        mems = _traces(45 + K, n=48, max_len=700)
        cases[f"K{K} {kind}"] = ([(_plans(45 + K, mems, K=K),
                                   RetrySpec(kind))], mems, 1.0, 12.0, 25)
    mems = _traces(46, n=30)
    for i in (0, 7, 19):
        mems[i] = np.zeros(0)
    cases["zero-length lanes"] = ([(_plans(46, mems), RetrySpec("ksplus"))],
                                  mems, 1.0, 12.0, 25)
    for dt in (0.5, 1.0, 2.5):
        mems, plans = _edge(dt)
        cases[f"ulp-edge dt{dt}"] = ([(plans, RetrySpec("ksplus")),
                                      (plans, RetrySpec("double"))],
                                     mems, dt, 16.0, 25)
    mems = _traces(47, n=60)
    cases["many jobs and buckets"] = (
        [(_plans(47 + s, mems, K=K), RetrySpec(kind))
         for s, (K, kind) in enumerate([(4, "ksplus"), (1, "double"),
                                        (8, "ksplus"), (4, "kseg-partial")])],
        mems, 0.5, 9.0, 25)
    return cases


# ------------------------------------------------------------- admission
DRAIN_K, DRAIN_G, DRAIN_TOL, DRAIN_NOW = 3, 16, 1e-9, 50.0
DRAIN_SWEEP = [(select, use_dur, N, Q)
               for select in ("first", "headroom") for use_dur in (True, False)
               for N in (1, 3, 4, 9) for Q in (1, 17, 256, 257)]


def _lanes(rng, n, K, G, use_dur):
    starts = np.full((n, K), PAD_START)
    peaks = np.zeros((n, K))
    grid = np.linspace(0.0, rng.uniform(30, 120, n), G, axis=1)
    for i in range(n):
        k = int(rng.integers(1, K + 1))
        starts[i, :k] = np.sort(np.concatenate(
            [[0.0], rng.uniform(1.0, 60.0, k - 1)]))
        peaks[i, :k] = np.sort(rng.uniform(2.0, 20.0, k))
        peaks[i, k:] = peaks[i, k - 1]
    need = alloc_at_packed(starts, peaks, grid)
    dur = rng.uniform(20.0, 100.0, n) if use_dur else None
    return starts, peaks, need, grid, dur


def _drain_case(seed, N, Q, use_dur, residents=(0, 4), caps=None):
    """Lanes (residents first per node, then the queue, then two spare
    lanes), residents admitted before ``DRAIN_NOW`` and the queue in a
    random order."""
    rng = np.random.default_rng(seed)
    per = rng.integers(residents[0], residents[1], N)
    B = int(per.sum()) + Q + 2
    starts, peaks, need, grid, dur = _lanes(rng, B, DRAIN_K, DRAIN_G,
                                            use_dur)
    order = rng.permutation(B)
    cut = np.cumsum(per)
    running = [order[a:b].tolist()
               for a, b in zip(np.concatenate([[0], cut[:-1]]), cut)]
    queue = order[cut[-1]:cut[-1] + Q]
    t0 = np.zeros(B)
    t0[order[:cut[-1]]] = DRAIN_NOW - rng.uniform(0.0, 80.0, cut[-1])
    caps = rng.uniform(20.0, 80.0, N) if caps is None \
        else np.asarray(caps, np.float64)
    return dict(starts=starts, peaks=peaks, need=need, grid=grid, dur=dur,
                caps=caps, running=running, queue=queue, t0=t0)


def _operands(c, device="cpu"):
    """The kernels' operands, as ``AdmissionState`` builds them."""
    B = c["starts"].shape[0]
    N = len(c["running"])
    R = max(max(len(r) for r in c["running"]), 1)
    run_idx = np.zeros((N, R), np.int64)
    run_valid = np.zeros((N, R), np.int64)
    for i, run in enumerate(c["running"]):
        run_idx[i, :len(run)] = run
        run_valid[i, :len(run)] = 1
    dur = np.full(B, np.inf) if c["dur"] is None else c["dur"]
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device)
    return (t(c["starts"]), t(c["peaks"]), t(np.append(c["t0"], 0.0)),
            t(dur), t(c["need"]), t(c["grid"]), t(c["caps"]), t(run_idx),
            t(run_valid), t(np.asarray(c["queue"], np.int64)),
            *(torch.tensor(x, dtype=torch.float64, device=device)
              for x in (DRAIN_NOW, DRAIN_TOL)))


def _special(kind, use_dur):
    """No residents anywhere; a lane that fits nowhere; ties (equal empty
    nodes); grazing fits inside the tol band."""
    if kind == "no-residents":
        return _drain_case(11, 4, 17, use_dur, residents=(0, 1))
    if kind == "fits-nowhere":
        c = _drain_case(12, 3, 17, use_dur)
        c["need"][c["queue"][[0, 5]]] += 1e3
        return c
    if kind == "ties":
        return _drain_case(13, 3, 17, use_dur, residents=(0, 1),
                           caps=(40.0, 40.0, 40.0))
    c = _drain_case(14, 2, 4, use_dur, residents=(0, 1), caps=(30.0, 30.0))
    q = c["queue"]
    c["need"][q[0]] = 30.0 + 0.5 * DRAIN_TOL   # fits node 0 only in the band
    c["need"][q[1]] = 30.0 + 0.5 * DRAIN_TOL   # then node 1
    c["need"][q[2]] = 30.0 + 2.0 * DRAIN_TOL   # fits nowhere
    c["need"][q[3]] = 1.0
    return c


SPECIAL = ["no-residents", "fits-nowhere", "ties", "grazing"]


# ---------------------------------------------------------- cluster replay
NODES = ((0, 48.0), (1, 64.0), (2, 32.0))


def _nodes(cls=Node, spec=NODES):
    return [cls(nid, cap) for nid, cap in spec]


def _assert_same(got, want):
    for field in ("placements", "retries", "evictions", "starved", "doomed",
                  "unschedulable", "finished", "makespan"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_allclose(got.total_wastage_gbs, want.total_wastage_gbs,
                               rtol=1e-6)
    np.testing.assert_allclose(got.avg_utilization, want.avg_utilization,
                               rtol=1e-6)
    np.testing.assert_allclose(got.starvation_s, want.starvation_s,
                               rtol=1e-6)


# --------------------------------------------------------------- serving
FIT_TOL = dict(rtol=1e-5, atol=1e-5)   # tests/test_torch_methods.py:94-95
GBS_RTOL = 1e-4


def _served(srv, tape):
    futs = [srv.submit("predict", t, f, x) for t, f, x in tape]
    srv.drain()
    return [f.result(0) for f in futs]


# ----------------------------------------------- SSD and flash attention
# kernel or plain version vs the reference: the reference tests' own
F32 = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
SSD_TOL = dict(atol=5e-3, rtol=5e-3)


# the sweeps of the reference's tests/test_kernels.py
FLASH_SHAPES = [(1, 128, 128, 4, 2, 64), (2, 64, 192, 4, 4, 32),
                (1, 256, 256, 8, 2, 16),
                (2, 128, 128, 2, 1, 64)]   # (B, Sq, Skv, H, K, hd); MQA last
SSD_SHAPES = [(1, 128, 2, 16, 1, 32, 32), (2, 256, 4, 64, 2, 64, 64),
              (1, 96, 2, 32, 1, 16, 32),     # padded sequence
              (1, 128, 8, 16, 4, 16, 128)]   # (B, S, H, P, G, N, chunk)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _qkv(seed, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32))


def _ssd_inputs(seed, B, S, H, P, G, N):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)) * 0.5,
            -np.abs(rng.standard_normal((B, S, H))) * 0.3,
            rng.standard_normal((B, S, G, N)) * 0.5,
            rng.standard_normal((B, S, G, N)) * 0.5)


_decode_case = decode_ops.ref.case  # seeded decode inputs

# (B, cap, H, K, hd, kind, window) of the kernel's checks on the card
DECODE_CHECKED = (
    (32, 1792, 16, 16, 128, "fill", None),   # the decode cell's caps
    (32, 960, 16, 16, 128, "fill", None),
    (8, 781, 16, 16, 128, "fill", None),     # the prefill cell's
    (8, 3853, 16, 16, 128, "full", None),
    (2, 1000, 64, 8, 128, "fill", None),     # G = 8 (qwen2-vl, llama3)
    (2, 1000, 48, 8, 128, "fill", None),     # G = 6 (dbrx)
    (1, 600, 96, 8, 128, "fill", None),      # G = 12: two head groups
    (3, 700, 16, 4, 128, "ring", 300),       # a ring cache, wrapped
    (1, 333, 32, 32, 80, "fill", None),      # cap off the tile; hd 80
    (4, 517, 32, 8, 160, "none", None),      # no valid slot; 320 B bf16 rows
)
