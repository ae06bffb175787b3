"""The ``fleet_engine`` kernel's arithmetic, its group tables, and the
grouped probes.

The CUDA kernel (``kernels/wastage/csrc/wastage.cu``) cannot run here, so a
numpy emulation of its per-lane engine — the exact slot bounds, the forward
walk of each sample to its slot, the O(K) span sums, the retry rules with
their constants rounded to float32 as the kernel gets them, one IEEE
float32 operation at a time — is held against the port's PyTorch engine
(:func:`repro_torch.kernels.wastage.ref.plain_engine`, the kernel's plain
version) and against the reference (``repro.core.fleet.simulate_fleet_many``,
``backend="jnp"``).  Attempts and successes must match exactly; wastage
within rtol 1e-4 (the reference's ``test_fleet`` tolerance: the emulation's
and the engines' trace sums are reduced in different orders).  The probe
emulation covers the one-hot select that lanes whose starts decrease take,
against the Pallas kernel in interpret mode.

``tests/test_torch_fleet_engine_card.py`` holds the kernel itself against
the plain engine and the grouped probes against one-group calls, on the
card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.fleet as f_ref
import repro_torch.core.fleet as f_pt
from repro.kernels.wastage.ops import oom_probe as oom_probe_pallas
from repro_torch.core import RetrySpec
from repro_torch.kernels.wastage import ops, ref

from torch_cases import ENGINE_KINDS as KINDS
from torch_cases import WTOL, F, _edge, _groups, _plans, _traces

INT_MAX = np.iinfo(np.int32).max


# ------------------------------------------------------------ the emulation
def seg_bound(s, dt):
    """First sample i with f32(i) * dt >= s, as ``seg_bound`` computes it."""
    c = F(min(max(np.ceil(F(s) / dt), F(0)), F(1e9)))
    if F(c - F(1)) * dt >= s:
        c = F(c - F(1))
    if F(min(max(c, F(0)), F(1e9))) * dt < s:
        c = F(c + F(1))
    return int(min(max(c, F(0)), F(2e9)))


def stage(st, dt):
    """Slot bounds (slot 0 from sample 0) and whether starts never
    decrease."""
    K = len(st)
    bounds = [0] + [seg_bound(st[k], dt) for k in range(1, K)]
    return bounds, all(st[k - 1] <= st[k] for k in range(1, K))


def onehot(st, pk, t):
    """The TPU kernel's select: active slots add up, none reads pk[0]."""
    acc, hit = F(0), False
    for k in range(len(st)):
        if st[k] <= t and (k + 1 == len(st) or t < st[k + 1]):
            acc, hit = F(acc + pk[k]), True
    return acc if hit else pk[0]


def walk(bounds, pk, mem, n, dt, st=None, stop=True):
    """The per-sample allocation in order: each sample walks the bounds
    forward to its slot (or, with ``st``, takes the one-hot select).
    Yields ``(i, alloc)``; with ``stop`` it ends after the first
    violation."""
    seg, K = 0, len(pk)
    for i in range(n):
        if st is None:
            while seg + 1 < K and bounds[seg + 1] <= i:
                seg += 1
            a = pk[seg]
        else:
            a = onehot(st, pk, F(F(i) * dt))
        yield i, a
        if stop and mem[i] > a:
            return


def span_sum(pk, bounds, upto):
    """sum_k pk_k * |[b_k, b_k+1) ∩ [0, upto)| slot by slot, no FMA."""
    acc = None
    for k in range(len(pk)):
        hi = bounds[k + 1] if k + 1 < len(pk) else INT_MAX
        term = F(pk[k] * F(max(min(hi, upto) - min(bounds[k], upto), 0)))
        acc = term if acc is None else F(acc + term)
    return acc


def retry(kind, st, pk, nseg, t_fail, used, mm, margin_mul, bump_mul):
    """One retry rule, slot by slot as the warp applies it."""
    K = len(st)
    k = np.arange(K)
    real = k < nseg
    if kind == "none":
        return st, pk
    if kind == "double":
        return st, np.minimum(pk * F(2), mm)
    if kind == "max-machine":
        return st, np.full(K, mm, F)
    j = min(max(int(np.sum(real & (st <= t_fail))) - 1, 0), nseg - 1)
    if kind.startswith("kseg"):
        target = max(F(pk[j] * margin_mul), F(used * margin_mul))
        pk = pk.copy()
        if kind == "kseg-selective":
            pk[j] = target
        else:
            pk = np.where(real & (k >= j), np.maximum(pk, target), pk)
        return st, pk.astype(F)
    nxt = st[min(j + 1, K - 1)]
    factor = F(t_fail / max(nxt, F(1e-30))) if nxt > 0 else F(0)
    s = np.where(real & (k > j + 1), st * factor, st).astype(F)
    s[k == j + 1] = t_fail
    s = np.maximum.accumulate(np.maximum(s, F(0)))
    s[0] = 0
    s = np.where(real, s, F(f_pt.PAD_START)).astype(F)
    p = np.where(k == nseg - 1, pk * bump_mul, pk).astype(F)
    p = np.maximum.accumulate(p)
    return (st, p) if j >= nseg - 1 else (s, pk)


def engine_lane(st, pk, nseg, mem, summem, dt, mm, kind, margin_mul,
                bump_mul, max_attempts):
    """One warp of the engine: ``(wastage, attempts, succeeded)``."""
    st, pk = st.astype(F), pk.astype(F)
    n = len(mem)
    if n == 0:
        return F(0), 1, True
    w, att, unsat = F(0), 0, None
    while True:
        att += 1
        cap = np.minimum(pk, mm).astype(F)
        bounds, mono = stage(st, dt)
        assert mono  # every plan the engine builds
        viol = -1
        for i, a in walk(bounds, cap, mem, n, dt):
            if mem[i] > a:
                viol = i
        if viol < 0:
            total = span_sum(cap, bounds, n)
            return F(w + F(F(total - summem) * dt)), att, True
        w = F(w + F(span_sum(cap, bounds, viol + 1) * dt))
        if unsat is None:  # samples before viol fit an allocation <= mm
            unsat = bool(np.any(mem[viol:] > mm))
        if unsat or att >= max_attempts:
            return w, att, False
        st, pk = retry(kind, st, cap, nseg, F(F(viol) * dt), mem[viol], mm,
                       margin_mul, bump_mul)


def emulate_many(jobs, mems, dt, machine_memory, max_attempts):
    """``simulate_fleet_many`` as the kernel runs it, lane by lane."""
    dt, mm = F(dt), F(machine_memory)
    rows = [np.asarray(m, F) for m in mems]
    summem = [F(np.sum(np.asarray(m, np.float64))) for m in mems]
    out = []
    for item in jobs:
        (starts, peaks, nseg), spec = item[0], item[1]
        bump = item[2] if len(item) > 2 else None
        res = []
        for b in range(len(mems)):
            # a per-lane bump adds in float32 in the kernel; the static
            # one arrives as float32(1 + bump), as PyTorch rounds it
            bump_mul = F(F(1) + F(spec.bump if np.isnan(bump[b])
                                  else bump[b])) \
                if bump is not None else F(1.0 + spec.bump)
            res.append(engine_lane(
                np.asarray(starts[b], F), np.asarray(peaks[b], F),
                int(nseg[b]), rows[b], summem[b], dt, mm, spec.kind,
                F(1.0 + spec.margin), bump_mul, max_attempts))
        w, att, succ = (np.asarray(x) for x in zip(*res))
        out.append((w, att, succ))
    return out


def probe_lane(st, pk, mem, n, dt):
    """One lane of ``oom_probe``: the walk for monotone starts, the one-hot
    select (and a second sum for w_kill) for starts that decrease."""
    st, pk, dt = st.astype(F), pk.astype(F), F(dt)
    bounds, mono = stage(st, dt)
    viol, succ = -1, 0.0
    for i, a in walk(bounds, pk, mem, n, dt, None if mono else st,
                     stop=False):
        succ += float(max(a, mem[i]) - mem[i])
        if viol < 0 and mem[i] > a:
            viol = i
    kill = 0.0
    if viol >= 0 and mono:
        kill = float(span_sum(pk, bounds, viol + 1))
    elif viol >= 0:
        kill = sum(float(onehot(st, pk, F(F(i) * dt)))
                   for i in range(viol + 1))
    return viol, succ * dt, kill * dt


# ------------------------------------------------------------------- inputs
def _check_all(jobs, mems, dt=1.0, machine_memory=12.0, max_attempts=25):
    """Emulation, port engine (CPU) and reference engine agree."""
    kw = dict(dt=dt, machine_memory=machine_memory, max_attempts=max_attempts)
    em = emulate_many(jobs, mems, dt, machine_memory, max_attempts)
    pt = f_pt.simulate_fleet_many(jobs, f_pt.bucket_traces(mems, device="cpu"),
                                  **kw)
    rf = f_ref.simulate_fleet_many(jobs, f_ref.bucket_traces(mems),
                                   backend="jnp", **kw)
    for (w, att, succ), p, r in zip(em, pt, rf):
        for other in (p, r):
            np.testing.assert_array_equal(att, other.attempts)
            np.testing.assert_array_equal(succ, other.succeeded)
            np.testing.assert_allclose(w, other.wastage_gbs, **WTOL)
    return em, pt


# -------------------------------------------------------------------- tests
class TestEmulatedEngine:
    @pytest.mark.parametrize("kind", KINDS)
    def test_every_retry_kind(self, kind):
        mems = _traces(11)
        plans = _plans(11, mems, nonmono=kind.startswith("kseg"))
        em, _ = _check_all([(plans, RetrySpec(kind))], mems)
        if kind in ("ksplus", "double", "kseg-partial"):
            assert (em[0][1] > 1).any()  # some lanes did retry

    def test_per_lane_bump_with_nan(self):
        mems = _traces(12)
        plans = _plans(12, mems)
        bump = np.random.default_rng(12).uniform(0.05, 0.6, len(mems))
        bump[::5] = np.nan  # NaN keeps the spec's static bump
        _check_all([(plans, RetrySpec("ksplus", bump=0.2), bump)], mems,
                   machine_memory=16.0)

    def test_unsatisfiable_lanes(self):
        mems = _traces(13)
        mems[0], mems[1] = np.full(20, 50.0), np.full(7, 30.0)
        em, _ = _check_all([(_plans(13, mems), RetrySpec("double"))], mems,
                           machine_memory=16.0, max_attempts=6)
        assert not em[0][2][0] and not em[0][2][1]

    def test_max_attempts_exhaustion(self):
        mems = [np.full(8, 10.0)] * 3
        plans = (np.zeros((3, 1), np.float32),
                 np.full((3, 1), 2.0, np.float32), np.ones(3, np.int32))
        em, _ = _check_all([(plans, RetrySpec("none"))], mems,
                           machine_memory=16.0, max_attempts=5)
        assert (em[0][1] == 5).all() and not em[0][2].any()

    @pytest.mark.parametrize("K,kind", [(1, "ksplus"), (32, "ksplus"),
                                        (32, "kseg-partial")])
    def test_plan_widths(self, K, kind):
        mems = _traces(14 + K, n=24, max_len=700)
        _check_all([(_plans(14 + K, mems, K=K), RetrySpec(kind))], mems)

    def test_zero_length_lanes(self):
        mems = _traces(15, n=20)
        for i in (0, 7, 19):
            mems[i] = np.zeros(0)
        em, _ = _check_all([(_plans(15, mems), RetrySpec("ksplus"))], mems)
        for i in (0, 7, 19):
            assert em[0][0][i] == 0 and em[0][1][i] == 1 and em[0][2][i]

    @pytest.mark.parametrize("dt", [0.5, 1.0, 2.5])
    def test_ulp_edge_starts(self, dt):
        mems, plans = _edge(dt)
        em, _ = _check_all([(plans, RetrySpec("ksplus")),
                            (plans, RetrySpec("double"))], mems, dt=dt,
                           machine_memory=16.0)
        # the bound decides: on the grid the lane fits, one ulp above it
        # the first sample of the step is killed
        assert (em[0][1][0::3] == 1).all() and (em[0][1][2::3] == 2).all()

    def test_many_jobs_and_buckets(self):
        mems = _traces(16, n=60)
        jobs = [(_plans(s, mems, K=K), RetrySpec(kind))
                for s, (K, kind) in enumerate([(4, "ksplus"), (1, "double"),
                                               (8, "ksplus"),
                                               (4, "kseg-partial")])]
        _check_all(jobs, mems, dt=0.5, machine_memory=9.0)


class TestEmulatedProbe:
    @pytest.mark.parametrize("case", ["monotone", "decreasing starts"])
    def test_probe_paths(self, case):
        rng = np.random.default_rng(21)
        B, T, K, dt = 8, 256, 4, 1.0
        starts = np.sort(rng.uniform(0, T * 0.8, (B, K)), axis=1)
        starts[:, 0] = 0
        if case == "decreasing starts":
            starts = starts[:, ::-1] * 0.5  # slots overlap; some add up
        starts = np.ascontiguousarray(starts, np.float32)
        peaks = np.sort(rng.uniform(1, 6, (B, K)), axis=1).astype(F)
        mems = np.abs(rng.normal(3, 1.5, (B, T))).astype(F)
        lengths = rng.integers(1, T, B).astype(np.int32)
        pv, ps, pk = (np.asarray(x) for x in oom_probe_pallas(
            starts, peaks, mems, lengths, dt=dt, interpret=True))
        rv, rs, rk = (t.numpy() for t in ref.oom_probe(*map(
            torch.from_numpy, (starts, peaks, mems, lengths)), dt))
        for b in range(B):
            bounds, mono = stage(starts[b], F(dt))
            assert mono == (case == "monotone")
            v, s, k = probe_lane(starts[b], peaks[b], mems[b],
                                 int(lengths[b]), dt)
            assert v == pv[b] == rv[b]
            np.testing.assert_allclose([s, k], [ps[b], pk[b]], rtol=1e-4,
                                       atol=1e-2)
            np.testing.assert_allclose([s, k], [rs[b], rk[b]], rtol=1e-4,
                                       atol=1e-2)

    def test_walk_equals_onehot_on_monotone_plans(self):
        """With starts that never decrease (duplicates and sentinels
        included) the walk and the one-hot select are one function."""
        st = F([0.0, 3.0, 3.0, 7.5, 1e30])
        pk = F([1.0, 2.0, 3.0, 4.0, 4.0])
        for dt in (0.5, 1.0, 2.5):
            bounds, mono = stage(st, F(dt))
            assert mono
            got = [a for _, a in walk(bounds, pk, np.zeros(40), 40, F(dt),
                                      stop=False)]
            want = [onehot(st, pk, F(F(i) * F(dt))) for i in range(40)]
            assert got == want


class TestGroupTable:
    def test_packing(self):
        """Records in order with their first lanes, every numpy plan array
        in one image 16-byte aligned after the records, pointers into it
        (at the buffer's base) or at the tensors' own storage."""
        groups = _groups()
        places, nbytes = ops.table_layout(groups)
        base = 1 << 40
        image = ops.table_image(groups, places, nbytes, base)
        assert image.nbytes == nbytes
        rec = image[:len(groups) * ops.GROUP_DTYPE.itemsize].view(
            ops.GROUP_DTYPE)
        np.testing.assert_array_equal(rec["lane0"], [0, 5, 8])
        np.testing.assert_array_equal(rec["B"], [5, 3, 7])
        np.testing.assert_array_equal(rec["K"], [4, 1, 8])
        np.testing.assert_array_equal(rec["T"], [128, 96, 701])
        np.testing.assert_array_equal(rec["kind"], 5)
        assert rec["margin"][0] == F(1.1) and rec["bump_mul"][0] == F(1.2)
        end = rec.nbytes
        for r, g, place in zip(rec, groups, places):
            assert r["mems"] == g.mems.data_ptr()
            assert r["lengths"] == g.lengths.data_ptr()
            assert r["summem"] == g.summem.data_ptr()
            assert (r["bump"] == 0) == (g.bump_lanes is None)
            for name, field in (("starts", "starts"), ("peaks", "peaks"),
                                ("nseg", "nseg"), ("bump_lanes", "bump")):
                x = getattr(g, name)
                if x is None:
                    continue
                off = place[name]
                assert off % 16 == 0 and off >= end
                assert r[field] == base + off
                np.testing.assert_array_equal(
                    image[off:off + x.nbytes].view(x.dtype).reshape(x.shape),
                    x)
                end = off + x.nbytes
        assert end == nbytes
        # rows of T = 701 take scalar loads
        np.testing.assert_array_equal(rec["vec"][[0, 1, 2]],
                                      [g.mems.data_ptr() % 16 == 0
                                       for g in groups[:2]] + [0])

    def test_cpu_table_and_grouped_probes(self):
        groups = _groups(32)
        table = ops.GroupTable(groups, "cpu")
        assert table.buf is None and table.n_lanes == 15
        np.testing.assert_array_equal(table.lane0, [0, 5, 8, 15])
        viol, ws, wk = ops.oom_probe_groups(table, 1.0)
        we = ops.wastage_eval_groups(table, 1.0)
        for g, lo in zip(groups, table.lane0):
            args = (torch.from_numpy(g.starts), torch.from_numpy(g.peaks),
                    g.mems[:g.B], g.lengths[:g.B])
            v, s, k = ops.oom_probe(*args)
            assert torch.equal(viol[lo:lo + g.B], v)
            assert torch.equal(ws[lo:lo + g.B], s)
            assert torch.equal(wk[lo:lo + g.B], k)
            assert torch.equal(we[lo:lo + g.B], ops.wastage_eval(*args))

    def test_contract(self):
        g = _groups(33)[2]
        cuda = torch.device("cuda")
        wide = ops.Group(np.zeros((2, 33), F), np.ones((2, 33), F), g.mems,
                         g.lengths)
        with pytest.raises(ValueError, match="K <= 32"):
            ops._check_group(wide, cuda)
        with pytest.raises(ValueError, match="contiguous"):
            ops.GroupTable([ops.Group(g.starts, g.peaks,
                                      g.mems.t().contiguous().t(),
                                      g.lengths)], "cpu")
        with pytest.raises(TypeError):
            ops.GroupTable([ops.Group(g.starts.astype(np.float64), g.peaks,
                                      g.mems, g.lengths)], "cpu")
        with pytest.raises(ValueError, match="retry kind"):
            ops.GroupTable([ops.Group(g.starts, g.peaks, g.mems, g.lengths,
                                      kind="triple")], "cpu")
        with pytest.raises(ValueError, match="max_attempts"):
            ops.fleet_engine(ops.GroupTable([g], "cpu"), 8.0, 1.0, 0)
        mems = _traces(34, n=4)
        starts, peaks, nseg = _plans(34, mems)
        starts[1] = starts[1][::-1].copy()  # decreasing starts
        with pytest.raises(ValueError, match="non-decreasing"):
            f_pt.simulate_fleet_many([((starts, peaks, nseg), "ksplus")],
                                     mems, device="cpu")

    @pytest.mark.parametrize("given", ["numpy", "tensor", "nan"])
    def test_engine_needs_nondecreasing_starts(self, given):
        """``fleet_engine`` holds its own contract for any caller: a lane
        whose starts decrease raises before either route runs, whether the
        starts came as numpy (checked before the upload) or as a tensor;
        a NaN start counts as a decrease.  The groups beside it run."""
        groups = _groups(37)
        starts = groups[2].starts.copy()
        if given == "nan":
            starts[4, 3] = np.nan
        else:
            starts[4, [2, 5]] = starts[4, [5, 2]]
        if given == "tensor":
            starts = torch.from_numpy(starts)
        groups[2] = dataclasses.replace(groups[2], starts=starts)
        table = ops.GroupTable(groups, "cpu")
        assert table.nondecreasing == (
            True, True, None if given == "tensor" else False)
        with pytest.raises(ValueError, match="non-decreasing"):
            ops.fleet_engine(table, 8.0, 1.0, 25)
        out = ops.fleet_engine(ops.GroupTable(groups[:2], "cpu"), 8.0, 1.0,
                               25)
        assert tuple(out.shape) == (3, 8) and (out[1] >= 1).all()

    def test_cpu_route_is_the_plain_engine(self):
        """A CPU batch runs the plain engine: no kernel launch, the same
        results as the engine called on the table directly."""
        mems = _traces(35, n=30)
        jobs = [(_plans(35, mems), RetrySpec("ksplus")),
                (_plans(36, mems, K=2), RetrySpec("double"))]
        batch = f_pt.bucket_traces(mems, device="cpu")
        ops.reset_launches()
        res = f_pt.simulate_fleet_many(jobs, batch, machine_memory=12.0)
        assert not any(ops.LAUNCHES.values())
        table, owners = f_pt._engine_table(jobs, batch)
        out = ref.plain_engine(table, 12.0, 1.0, 25).numpy()
        for (j, idx), lo, hi in zip(owners, table.lane0[:-1],
                                    table.lane0[1:]):
            np.testing.assert_array_equal(res[j].attempts[idx],
                                          out[1][lo:hi])
            np.testing.assert_array_equal(
                res[j].wastage_gbs[idx], out[0][lo:hi].view(F))

