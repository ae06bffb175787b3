"""The admission kernels' plain versions (``repro_torch.kernels.admission``)
against the reference, on the CPU, and the kernels against them on the card.

The reference's own programs (``_fused_kernel``, ``_drain_kernel``) need
``jax.experimental.enable_x64``, which this environment lacks, so the
oracles are its numpy ones: ``repro.core.envelope.fits_column`` for the
columns and ``repro.sched.admission.AdmissionState(backend="numpy")`` for
the drain.  Inputs come from a numpy seed over ``select`` x ``use_dur`` x
N in {1, 3, 4, 9} x Q in {1, 17, 256, 257}, plus nodes without residents, a
lane that fits nowhere, ties and grazing fits inside the ``tol`` band.
Placements, fits, counts and admission times are exact; minimum residuals
within 1e-12 relative (the reference tests' tolerance: only the order of
the residents' sum may differ).

``_emulate`` rehearses the drain kernel's design (``csrc/admission.cu``) in
numpy: residents summed in order from 0.0, a fit table, each node's first
chooser, the conflict cut where a lane fits a node an earlier lane chose,
slots from a prefix sum.  It is a test helper only, held to the plain
version, also past 64 nodes.

The ``cuda``-marked tests hold the kernels to the plain versions on the
same CUDA tensors, and count one ``admit_drain`` launch and one host read
per drain through ``AdmissionState`` on the card.
"""

import numpy as np
import pytest
import torch

from repro.core.envelope import fits_column
from repro.sched.admission import AdmissionState as RAdmission
from repro_torch.analysis.contracts import dispatch_budget
from repro_torch.kernels.admission import ops, ref
from repro_torch.sched import AdmissionState

from test_torch_sched import _lanes

K, G, TOL, NOW = 3, 16, 1e-9, 50.0
SWEEP = [(select, use_dur, N, Q)
         for select in ("first", "headroom") for use_dur in (True, False)
         for N in (1, 3, 4, 9) for Q in (1, 17, 256, 257)]


def _case(seed, N, Q, use_dur, residents=(0, 4), caps=None):
    """Lanes (residents first per node, then the queue, then two spare
    lanes), residents admitted before ``NOW`` and the queue in a random
    order."""
    rng = np.random.default_rng(seed)
    per = rng.integers(residents[0], residents[1], N)
    B = int(per.sum()) + Q + 2
    starts, peaks, need, grid, dur = _lanes(rng, B, K, G, use_dur)
    order = rng.permutation(B)
    cut = np.cumsum(per)
    running = [order[a:b].tolist()
               for a, b in zip(np.concatenate([[0], cut[:-1]]), cut)]
    queue = order[cut[-1]:cut[-1] + Q]
    t0 = np.zeros(B)
    t0[order[:cut[-1]]] = NOW - rng.uniform(0.0, 80.0, cut[-1])
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
              for x in (NOW, TOL)))


def _reference(c, use_dur, select):
    """The reference's numpy drain over the case: ``[(lane, node)]`` and
    its admission times."""
    adm = RAdmission(c["caps"], K=K, G=G, backend="numpy", use_dur=use_dur,
                     tol=TOL)
    adm.add_lanes(c["starts"], c["peaks"], c["need"], c["grid"], c["dur"])
    for ni, run in enumerate(c["running"]):
        for lane in run:
            adm.place(ni, lane, c["t0"][lane])
    return adm.drain(NOW, c["queue"].tolist(), select=select), adm.admit_t


def _decode(vec, Q):
    vec = vec.cpu().numpy()
    n = int(vec[0])
    return list(zip(vec[2:2 + n].tolist(), vec[2 + Q:2 + Q + n].tolist()))


def _held_columns(c, use_dur, got):
    """``(2, N, Q)`` plain columns against ``fits_column`` per node."""
    q = c["queue"]
    for n, run in enumerate(c["running"]):
        ok, resid = fits_column(
            c["caps"][n], c["starts"][run], c["peaks"][run], c["t0"][run],
            c["need"][q], NOW + c["grid"][q],
            dur=c["dur"][run] if use_dur else None, tol=TOL)
        np.testing.assert_array_equal(got[0, n] != 0, ok)
        np.testing.assert_allclose(got[1, n], resid.min(axis=-1),
                                   rtol=1e-12, atol=0)


def _special(kind, use_dur):
    """No residents anywhere; a lane that fits nowhere; ties (equal empty
    nodes); grazing fits inside the tol band."""
    if kind == "no-residents":
        return _case(11, 4, 17, use_dur, residents=(0, 1))
    if kind == "fits-nowhere":
        c = _case(12, 3, 17, use_dur)
        c["need"][c["queue"][[0, 5]]] += 1e3
        return c
    if kind == "ties":
        return _case(13, 3, 17, use_dur, residents=(0, 1),
                     caps=(40.0, 40.0, 40.0))
    c = _case(14, 2, 4, use_dur, residents=(0, 1), caps=(30.0, 30.0))
    q = c["queue"]
    c["need"][q[0]] = 30.0 + 0.5 * TOL   # fits node 0 only in the band
    c["need"][q[1]] = 30.0 + 0.5 * TOL   # then node 1
    c["need"][q[2]] = 30.0 + 2.0 * TOL   # fits nowhere
    c["need"][q[3]] = 1.0
    return c


SPECIAL = ["no-residents", "fits-nowhere", "ties", "grazing"]


# ----------------------------------------------- plain versions vs reference
@pytest.mark.parametrize("select,use_dur,N,Q", SWEEP)
def test_plain_drain_matches_reference(select, use_dur, N, Q):
    c = _case(N * 1000 + Q, N, Q, use_dur)
    operands = _operands(c)
    vec = ref.plain_drain(*operands, use_dur, select)
    want, want_t = _reference(c, use_dur, select)
    assert _decode(vec, Q) == want
    assert vec[2 + len(want):2 + Q].eq(c["starts"].shape[0]).all()
    np.testing.assert_array_equal(operands[2][:-1].numpy(), want_t)
    assert 1 <= int(vec[1]) <= len(want) + 1
    _held_columns(c, use_dur, ref.plain_columns(*operands, use_dur))


@pytest.mark.parametrize("kind", SPECIAL)
@pytest.mark.parametrize("select", ["first", "headroom"])
@pytest.mark.parametrize("use_dur", [True, False])
def test_plain_drain_edge_cases(kind, select, use_dur):
    c = _special(kind, use_dur)
    operands = _operands(c)
    vec = ref.plain_drain(*operands, use_dur, select)
    want, want_t = _reference(c, use_dur, select)
    assert _decode(vec, len(c["queue"])) == want
    np.testing.assert_array_equal(operands[2][:-1].numpy(), want_t)
    _held_columns(c, use_dur, ref.plain_columns(*operands, use_dur))
    placed = {lane for lane, _ in want}
    q = c["queue"]
    if kind == "fits-nowhere":
        assert q[0] not in placed and q[5] not in placed
    if kind == "grazing":
        assert dict(want).get(q[0]) is not None and q[2] not in placed
        assert {dict(want)[q[0]], dict(want)[q[1]]} == {0, 1}
    if kind == "ties" and select == "headroom":
        assert want[0][1] == 0  # first node on ties


@pytest.mark.parametrize("N,Q", [(65, 17), (130, 40)])
@pytest.mark.parametrize("select", ["first", "headroom"])
@pytest.mark.parametrize("use_dur", [True, False])
def test_plain_drain_past_64_nodes(N, Q, select, use_dur):
    """Clusters wider than one 64-bit word of nodes drain as the
    reference's numpy oracle drains them."""
    c = _case(N * 1000 + Q, N, Q, use_dur)
    operands = _operands(c)
    vec = ref.plain_drain(*operands, use_dur, select)
    want, want_t = _reference(c, use_dur, select)
    assert _decode(vec, Q) == want and want
    np.testing.assert_array_equal(operands[2][:-1].numpy(), want_t)


# ----------------------------------------- the kernel's design, rehearsed
def _chain(s, p, relc):
    a = np.broadcast_to(p[..., 0:1], relc.shape).copy()
    for k in range(1, s.shape[-1]):
        a = np.where(s[..., k:k + 1] <= relc, p[..., k:k + 1], a)
    return a


def _emulate(operands, masked, select):
    """``csrc/admission.cu``'s drain in numpy: ``(vec, admit_t, resid0)``."""
    (starts, peaks, admit_t, dur, need, grid, caps, run_idx, run_valid,
     q_idx, now, tol) = (x.numpy().copy() for x in operands)
    N, R = run_idx.shape
    Q, B = len(q_idx), starts.shape[0]
    tabs = now + grid[q_idx]                              # (Q, G)

    def windowed(lane, rel):
        a = _chain(starts[lane][None], peaks[lane][None],
                   np.where(rel < 0.0, 0.0, rel))
        if masked:
            a = np.where((rel >= 0.0) & (rel < dur[lane] + ref.WINDOW), a,
                         0.0)
        return a

    resid = np.empty((N, Q, G))
    for n in range(N):
        usage = np.zeros((Q, G))
        for r in range(R):          # in order, from 0.0
            lane = run_idx[n, r]
            a = windowed(lane, tabs - admit_t[lane])
            usage = usage + np.where(run_valid[n, r] != 0, a, 0.0)
        resid[n] = caps[n] - usage
    resid0 = resid.copy()
    peakq = peaks[q_idx].max(axis=1)
    lanes, nodes = np.full(Q, B), np.full(Q, B)
    active = np.ones(Q, bool)
    count = iterations = 0
    while True:
        iterations += 1
        assert iterations <= Q + 1  # the kernel's __trap
        fit = np.zeros((N, Q), bool)
        anyfit, node = np.zeros(Q, bool), np.zeros(Q, np.int64)
        for q in np.nonzero(active)[0]:
            best = -np.inf
            for n in range(N):
                fit[n, q] = np.all(need[q_idx[q]] <= resid[n, q] + tol)
                if not fit[n, q]:
                    continue
                head = resid[n, q].min() - peakq[q]
                if not anyfit[q] or (select == "headroom" and head > best):
                    best, node[q] = head, n
                anyfit[q] = True
        if not anyfit.any():
            break
        chooser = np.full(N, Q)                  # node -> first lane
        for q in np.nonzero(anyfit)[0]:
            chooser[node[q]] = min(chooser[node[q]], q)
        conflict = [q for q in range(Q)
                    if anyfit[q] and (fit[:, q] & (chooser < q)).any()]
        first_conf = min(conflict, default=Q)
        for q in range(Q):
            if anyfit[q] and q < first_conf:
                lanes[count], nodes[count] = q_idx[q], node[q]
                count += 1
                assert chooser[node[q]] == q   # one lane a node
                active[q] = False
        for n in range(N):
            if chooser[n] < first_conf:
                resid[n] = resid[n] - windowed(q_idx[chooser[n]], tabs - now)
    admit_t[lanes] = now
    return (np.concatenate([[count, iterations], lanes, nodes]), admit_t,
            resid0)


@pytest.mark.parametrize("select,use_dur,N,Q",
                         [s for s in SWEEP if s[3] != 256]
                         + [(s, u, 65, 17) for s in ("first", "headroom")
                            for u in (True, False)])
def test_kernel_design_matches_plain(select, use_dur, N, Q):
    """The emulated kernel gives the plain drain's vector and admission
    times exactly, and the plain columns' fits (minimum residuals at the
    precision contract's 1e-12); its node axis has no limit."""
    c = _case(N * 1000 + Q, N, Q, use_dur)
    got_vec, got_t, resid0 = _emulate(_operands(c), use_dur, select)
    operands = _operands(c)
    np.testing.assert_array_equal(
        got_vec, ref.plain_drain(*operands, use_dur, select).numpy())
    np.testing.assert_array_equal(got_t, operands[2].numpy())
    cols = ref.plain_columns(*_operands(c), use_dur).numpy()
    q_need = c["need"][c["queue"]]
    np.testing.assert_array_equal(
        cols[0] != 0, np.all(q_need[None] <= resid0 + TOL, axis=-1))
    np.testing.assert_allclose(cols[1], resid0.min(axis=-1), rtol=1e-12,
                               atol=0)


# ------------------------------------------------------------- the wrappers
def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    ops.reset_launches()
    c = _case(5, 4, 17, True)
    got = ops.admit_columns(*_operands(c), True)
    assert torch.equal(got, ref.plain_columns(*_operands(c), True))
    operands = _operands(c)
    vec, reads = ops.admit_drain(*operands, True, "first")
    plain = _operands(c)
    assert torch.equal(vec, ref.plain_drain(*plain, True, "first"))
    assert torch.equal(operands[2], plain[2])
    assert reads == int(vec[1])   # the plain loop's done flag an iteration
    assert ops.LAUNCHES == {"admit_columns": 0, "admit_drain": 0}


def _swap(operands, i, x):
    return operands[:i] + (x,) + operands[i + 1:]


@pytest.mark.parametrize("bad,match", [
    (lambda o: _swap(o, 0, o[0].float()), "starts must be torch.float64"),
    (lambda o: _swap(o, 9, o[9].int()), "q_idx must be torch.int64"),
    (lambda o: _swap(o, 4, o[4].t().contiguous().t()),
     "need must be contiguous"),
    (lambda o: _swap(o, 2, o[2][:-1].contiguous()),
     r"admit_t \(\d+,\) must be"),
    (lambda o: _swap(o, 6, o[6][:-1].contiguous()), "over caps"),
    (lambda o: _swap(o, 9, o[9][:0]), "q_idx must be"),
    (lambda o: _swap(o, 10, o[10].reshape(1)), "0-d tensors"),
    (lambda o: _swap(o, 5, o[5][:, :-1].contiguous()), "need .* and grid"),
])
def test_wrappers_raise_on_what_the_kernels_do_not_take(bad, match):
    operands = bad(_operands(_case(6, 3, 17, True)))
    with pytest.raises((TypeError, ValueError), match=match):
        ops.admit_columns(*operands, True)
    with pytest.raises((TypeError, ValueError), match=match):
        ops.admit_drain(*operands, True, "first")
    with pytest.raises(ValueError, match="unknown drain select"):
        ops.admit_drain(*_operands(_case(6, 3, 17, True)), True, "best")


def test_book_decodes_the_kernel_vector():
    """A hand-made vector ``[count, iterations, lanes[Q], nodes[Q]]``
    books its placements in slot order and nothing past ``count``."""
    rng = np.random.default_rng(2)
    adm = AdmissionState((40.0, 30.0, 50.0), K=K, G=G, device="cpu")
    adm.add_lanes(*_lanes(rng, 8, K, G, True))
    adm.columns(3.0, list(range(8)))
    fits_before = adm.fits.copy()
    B, Q = adm.B, 5
    host = np.array([3, 2, 6, 1, 4, B, B, 2, 0, 2, B, B], np.int64)
    placed = adm._book(3.0, host, Q)
    assert placed == [(6, 2), (1, 0), (4, 2)]
    assert adm.running == [[1], [], [6, 4]]
    assert adm.admit_t[[6, 1, 4]].tolist() == [3.0] * 3
    assert adm.admit_t[[0, 2, 3, 5, 7]].tolist() == [0.0] * 5
    # node 1 untouched; the placed nodes keep only their False entries
    np.testing.assert_array_equal(adm.valid[1], np.ones(8, bool))
    for ni in (0, 2):
        np.testing.assert_array_equal(adm.valid[ni], ~fits_before[ni])


# ----------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("select,use_dur", [
        (s, u) for s in ("first", "headroom") for u in (True, False)])
    def test_kernels_match_plain(self, select, use_dur):
        _card()
        cases = [_case(N * 1000 + Q, N, Q, use_dur)
                 for _, u, N, Q in SWEEP if u == use_dur]
        cases += [_special(k, use_dur) for k in SPECIAL]
        # past one 64-bit word of nodes
        cases += [_case(21, 65, 256, use_dur), _case(22, 130, 257, use_dur)]
        for c in cases:
            kern, plain = _operands(c, "cuda"), _operands(c, "cuda")
            vec, reads = ops.admit_drain(*kern, use_dur, select)
            assert reads == 1
            want = ref.plain_drain(*plain, use_dur, select)
            torch.cuda.synchronize()
            assert torch.equal(vec, want)
            assert torch.equal(kern[2], plain[2])
            got = ops.admit_columns(*kern, use_dur)
            want = ref.plain_columns(*plain, use_dur)
            assert torch.equal(got[0], want[0])
            torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0)

    def test_one_launch_and_one_host_read_per_drain(self):
        """``TestOneProgramPerDrain`` on the card: each drain is one
        ``admit_drain`` launch and one host read, with no build or load
        after the first; a backlog past ``DRAIN_CAP`` adds one
        ``admit_columns`` launch and read per pre-filter refresh."""
        _card()
        rng = np.random.default_rng(8)
        lanes = _lanes(rng, 300, K, G, True)
        states = [AdmissionState((40.0, 20.0, 36.0, 64.0), K=K, G=G,
                                 device=d) for d in ("cuda", "cpu")]
        for adm in states:
            adm.add_lanes(*lanes)
        card, cpu = states
        assert card.drain(0.0, [0, 1]) == cpu.drain(0.0, [0, 1])  # warm-up
        steps = ((3.0, range(2, 14)), (7.0, range(14, 300)),
                 (40.0, range(2, 40)))
        want = [cpu.drain(now, list(queue)) for now, queue in steps]
        before = dict(ops.LAUNCHES)
        stats0 = dict(card.stats)
        with dispatch_budget(compiles=0) as b:   # the card's drains alone
            got = [card.drain(now, list(queue)) for now, queue in steps]
        assert got == want
        st = {k: card.stats[k] - stats0[k] for k in card.stats}
        drains = ops.LAUNCHES["admit_drain"] - before["admit_drain"]
        refreshes = ops.LAUNCHES["admit_columns"] - before["admit_columns"]
        assert drains == st["drain_dispatches"] \
            == b.tag_counts["admission.drain"] >= 3
        assert refreshes == b.tag_counts["admission.columns"] >= 1
        assert st["host_reads"] == drains + refreshes
        assert st["drain_iterations"] > drains
        np.testing.assert_array_equal(card.admit_t, cpu.admit_t)
        assert torch.equal(card._dadmit[:card.B].cpu(),
                           torch.from_numpy(card.admit_t))

    @pytest.mark.parametrize("select", ["first", "headroom"])
    def test_wide_cluster_drains_through_the_kernel(self, select):
        """65 and 130 nodes through ``AdmissionState`` on the card: each
        drain one ``admit_drain`` launch and one host read, placements and
        admission times equal to the CPU state's."""
        _card()
        rng = np.random.default_rng(9)
        for N in (65, 130):
            caps = rng.uniform(10.0, 40.0, N)
            lanes = _lanes(rng, 600, K, G, True)
            card, cpu = (AdmissionState(caps, K=K, G=G, device=d)
                         for d in ("cuda", "cpu"))
            for adm in (card, cpu):
                adm.add_lanes(*lanes)
            before = dict(ops.LAUNCHES)
            queue = list(range(600))
            for now in (0.0, 5.0, 30.0):
                got = card.drain(now, queue[:200], select)
                assert got == cpu.drain(now, queue[:200], select) and got
                placed = {lane for lane, _ in got}
                queue = [q for q in queue if q not in placed]
            assert ops.LAUNCHES["admit_drain"] - before["admit_drain"] \
                == card.stats["drain_dispatches"] == 3
            assert card.stats["host_reads"] == 3
            np.testing.assert_array_equal(card.admit_t, cpu.admit_t)

    def test_elastic_planner_drains_through_the_kernel(self):
        """The elastic planner (``use_dur=False``, head-room rule) on the
        card: joins, submissions, drains, finishes and a leave decide as
        on the CPU, one ``admit_drain`` launch a drain program."""
        _card()
        from repro_torch.core import AllocationPlan
        from repro_torch.sched import ElasticPlanner
        planners = [ElasticPlanner(backend="fused", device=d)
                    for d in ("cuda", "cpu")]
        before = dict(ops.LAUNCHES)
        rng = np.random.default_rng(4)
        events = []
        for step in range(300):
            k = int(rng.integers(1, 4))
            peak = float(rng.uniform(4.0, 30.0))
            plan = dict(starts=np.sort(np.concatenate(
                [[0.0], rng.uniform(5.0, 200.0, k - 1)])),
                peaks=np.sort(rng.uniform(peak / 2, peak, k)))
            events.append(("submit", f"j{step}", plan, float(step)))
            if step % 40 == 0:
                events.append(("join", f"n{step}", 48.0 + step / 10,
                               float(step)))
            if step % 25 == 24:
                events.append(("finish", f"j{step - 20}", None, None))
                events.append(("drain", None, None, float(step)))
        events.append(("leave", "n40", None, 300.0))
        events.append(("drain", None, None, 301.0))
        out = []
        for pl in planners:
            log_ = []
            for kind, name, arg, now in events:
                if kind == "submit":
                    log_.append(pl.submit(name, AllocationPlan(**arg), now))
                elif kind == "join":
                    log_.append(sorted(pl.node_join(name, arg, now=now)
                                       .items()))
                elif kind == "finish":
                    if any(j == name for sl in pl.slices.values()
                           for j, _, _ in sl.jobs):
                        pl.finish(name)
                elif kind == "drain":
                    log_.append(sorted(pl.drain(now).items()))
                else:
                    log_.append(pl.node_leave(name, now=now))
            out.append(log_)
        assert out[0] == out[1]
        st = planners[0]._adm.stats
        drains = ops.LAUNCHES["admit_drain"] - before["admit_drain"]
        refreshes = ops.LAUNCHES["admit_columns"] - before["admit_columns"]
        assert drains == st["drain_dispatches"] > 0
        assert st["host_reads"] == drains + refreshes
