"""The node-sharded admission drain over real process groups: 2 and 4 CPU
processes (gloo), as ``tests/test_device_drain.py`` holds the reference's
``shard_map`` drain.

* ``AdmissionState(shard=n).drain`` at 2 and 4 shards, both ``select``
  rules, over a 6-node cluster (padded to 8 nodes at 4 shards) and two
  drains with residents between them, places what the port's unsharded
  drain and the reference's numpy ``AdmissionState`` place, decision for
  decision, with 2 (``"first"``) or 3 (``"headroom"``) collectives an
  iteration.
* A ``ClusterSim(shard=2)`` replay with a node leave and a node join gives
  the placements, retries, evictions, unschedulable count and makespan of
  the port's unsharded replay and of the reference's ``packed`` and
  ``legacy`` engines.

Every rank runs the same drains and the same replay; each runs in a
subprocess with a timeout, the processes rendezvous on a free localhost
port.
"""

import functools
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

from repro.core import AllocationPlan as RPlan
from repro.core import RetrySpec as RSpec
from repro.core import ksplus_retry as r_ksplus_retry
from repro.sched import AdmissionState as RAdmission
from repro.sched import ClusterSim as RSim
from repro.sched import FaultEvent as RFaultEvent
from repro.sched import Job as RJob
from repro.sched import Node as RNode
from repro_torch.core import AllocationPlan, RetrySpec
from repro_torch.core.envelope import PAD_START, alloc_at_packed
from repro_torch.sched import AdmissionState, ClusterSim, FaultEvent, Job, \
    Node

CPU = "cpu"
CAPS = (32.0, 48.0, 24.0, 40.0, 28.0, 36.0)
K, G, LANES = 3, 16, 40
DRAINS = ((2.0, slice(0, 18)), (6.0, slice(18, LANES)))

_SHARED = '''
import numpy as np

CAPS = %(caps)r
K, G, LANES = %(K)d, %(G)d, %(lanes)d
DRAINS = ((2.0, slice(0, 18)), (6.0, slice(18, LANES)))


def lanes(seed, alloc_at_packed, pad_start):
    """Seeded packed lanes (the reference tests' ``_mk_lanes``)."""
    rng = np.random.default_rng(seed)
    starts = np.full((LANES, K), pad_start)
    peaks = np.zeros((LANES, K))
    grid = np.linspace(0.0, rng.uniform(30, 120, LANES), G, axis=1)
    for i in range(LANES):
        k = int(rng.integers(1, K + 1))
        starts[i, :k] = np.sort(np.concatenate(
            [[0.0], rng.uniform(1.0, 60.0, k - 1)]))
        peaks[i, :k] = np.sort(rng.uniform(2.0, 20.0, k))
        peaks[i, k:] = peaks[i, k - 1]
    need = alloc_at_packed(starts, peaks, grid)
    dur = rng.uniform(20.0, 100.0, LANES)
    return starts, peaks, need, grid, dur


def workload(job_cls, plan_cls, n_jobs=48, seed=2, under_frac=0.25, dt=1.0):
    """The reference suites' seeded two-segment mix (``_workload`` of
    ``tests/test_cluster_packed.py``)."""
    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(n_jobs):
        L = int(rng.integers(24, 90))
        split = int(rng.uniform(0.4, 0.8) * L)
        lo = float(rng.uniform(1.5, 3.0))
        hi = float(rng.uniform(5.0, 11.0))
        mem = np.concatenate([np.full(split, lo), np.full(L - split, hi)])
        mem = mem * (1.0 + 0.02 * np.sin(np.arange(L)))
        under = rng.uniform() < under_frac
        scale = 0.9 if under else 1.12
        plan = plan_cls(
            starts=np.asarray([0.0, max(split * dt - 2.0, 1.0)]),
            peaks=np.asarray([lo * 1.15, hi * scale]))
        jobs.append(job_cls(jid=j, family="t", input_gb=1.0, mem=mem, dt=dt,
                            plan=plan, est_runtime=float(L * dt)))
    return jobs


NODES = ((0, 48.0), (1, 64.0), (2, 32.0), (3, 96.0))
FAULTS = ((30.0, "leave", 1, 0.0), (60.0, "join", 1, 72.0))
''' % dict(caps=CAPS, K=K, G=G, lanes=LANES)

_WORKERS = _SHARED + textwrap.dedent('''
import os, socket, sys, traceback
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, port, path):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.core import AllocationPlan, RetrySpec
        from repro_torch.core.envelope import PAD_START, alloc_at_packed
        from repro_torch.sched import (AdmissionState, ClusterSim,
                                       FaultEvent, Job, Node)
        out = {}
        for select in ("first", "headroom"):
            adm = AdmissionState(CAPS, K=K, G=G, use_dur=True, shard=world,
                                 device="cpu")
            adm.add_lanes(*lanes(13, alloc_at_packed, PAD_START))
            placed = []
            for now, part in DRAINS:
                placed += adm.drain(now, list(range(LANES))[part],
                                    select=select)
            out[select] = np.asarray(placed, np.int64).reshape(-1, 2)
            out[select + " stats"] = np.asarray(
                [adm.stats[k] for k in ("drain_iterations",
                                        "drain_dispatches", "collectives",
                                        "host_reads")])
        if world == 2:
            sim = ClusterSim([Node(n, c) for n, c in NODES], shard=world,
                             device="cpu")
            res = sim.run(workload(Job, AllocationPlan),
                          RetrySpec("ksplus"),
                          faults=[FaultEvent(*f) for f in FAULTS])
            out["placements"] = np.asarray(res.placements, np.float64)
            out["counts"] = np.asarray([res.retries, res.evictions,
                                        res.unschedulable])
            out["makespan"] = np.asarray(res.makespan)
            out["collectives"] = np.asarray(sim.stats["collectives"])
        assert dist.get_world_size() == world  # the caller's group stays
        if rank == 0:
            np.savez(path, **out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    world, path = int(sys.argv[1]), sys.argv[2]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(world, port, path), nprocs=world,
                       start_method="spawn")
    print("WORKERS-OK")
''')

# the workers' helpers, run here too: one source for both sides
_ns: dict = {}
exec(_SHARED, _ns)


@functools.lru_cache(maxsize=None)
def _sharded(world):
    """The workers' results at ``world`` shards (once per module run)."""
    root = tempfile.mkdtemp(prefix=f"drain{world}_")
    try:
        script = os.path.join(root, "workers.py")
        with open(script, "w") as f:
            f.write(_WORKERS)
        out = os.path.join(root, "out.npz")
        env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
        r = subprocess.run([sys.executable, script, str(world), out],
                           cwd=os.getcwd(), env=env, capture_output=True,
                           text=True, timeout=300)
        assert "WORKERS-OK" in r.stdout and os.path.exists(out), \
            r.stdout + r.stderr
        with np.load(out) as data:
            return dict(data)
    finally:
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("select", ["first", "headroom"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_drain_equals_unsharded_and_reference(world, select):
    got = _sharded(world)
    want = {}
    for name, adm in (
            ("port", AdmissionState(CAPS, K=K, G=G, use_dur=True,
                                    device=CPU)),
            ("numpy", RAdmission(CAPS, K=K, G=G, backend="numpy",
                                 use_dur=True))):
        adm.add_lanes(*_ns["lanes"](13, alloc_at_packed, PAD_START))
        placed = []
        for now, part in DRAINS:
            placed += adm.drain(now, list(range(LANES))[part],
                                select=select)
        want[name] = placed
    assert want["port"] == want["numpy"]
    assert len(want["numpy"]) > 4
    assert [tuple(x) for x in got[select].tolist()] == want["numpy"]
    iters, dispatches, collectives, reads = got[select + " stats"]
    assert dispatches == len(DRAINS)
    assert iters == len(want["numpy"]) + dispatches  # one lane each
    assert collectives == (2 if select == "first" else 3) * iters
    assert reads == iters


def test_sharded_replay_with_churn_equals_engines():
    got = _sharded(2)
    faults = _ns["FAULTS"]
    port = ClusterSim([Node(n, c) for n, c in _ns["NODES"]],
                      device=CPU).run(
        _ns["workload"](Job, AllocationPlan), RetrySpec("ksplus"),
        faults=[FaultEvent(*f) for f in faults])
    ref = {}
    for engine, retry in (("packed", RSpec("ksplus")),
                          ("legacy", r_ksplus_retry)):
        ref[engine] = RSim([RNode(n, c) for n, c in _ns["NODES"]],
                           engine=engine).run(
            _ns["workload"](RJob, RPlan), retry,
            faults=[RFaultEvent(*f) for f in faults])
    placements = [(t, int(n), int(j)) for t, n, j in got["placements"]]
    assert port.evictions > 0 and port.retries > 0
    for res in (port, ref["packed"], ref["legacy"]):
        assert placements == res.placements
        assert got["counts"].tolist() == [res.retries, res.evictions,
                                          res.unschedulable]
        assert float(got["makespan"]) == res.makespan
    assert int(got["collectives"]) > 0
