"""The admission kernels (``admit_drain``, ``admit_columns``) on the card.

Against their plain versions (``kernels/admission/ref.py``) on the same
CUDA tensors over the CPU tests' sweep (``select`` x ``use_dur`` x N in
{1, 3, 4, 9} x Q in {1, 17, 256, 257}, the edge cases, and 65 and 130
nodes, past one 64-bit word of nodes): the drain's vector and admission
times exact, fits exact, minimum residuals within 1e-12 relative.  Then
``AdmissionState`` and ``ElasticPlanner`` on the card against the same on
the CPU, one ``admit_drain`` launch and one host read a drain.
``tests/test_torch_admission_kernel.py`` holds the plain versions against
the reference.
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.contracts import dispatch_budget
from repro_torch.kernels.admission import ops, ref
from repro_torch.sched import AdmissionState
from torch_cases import DRAIN_G as G
from torch_cases import DRAIN_K as K
from torch_cases import (DRAIN_SWEEP, SPECIAL, _drain_case, _lanes,
                         _operands, _special)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("select,use_dur", [
        (s, u) for s in ("first", "headroom") for u in (True, False)])
    def test_kernels_match_plain(self, select, use_dur):
        _card()
        cases = [_drain_case(N * 1000 + Q, N, Q, use_dur)
                 for _, u, N, Q in DRAIN_SWEEP if u == use_dur]
        cases += [_special(k, use_dur) for k in SPECIAL]
        # past one 64-bit word of nodes
        cases += [_drain_case(21, 65, 256, use_dur),
                  _drain_case(22, 130, 257, use_dur)]
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
