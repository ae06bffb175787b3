"""The port's ``workloads/`` against the reference package, on the CPU.

* Shape math: the port's scalar and trace functions, fed the reference's
  threefry normals, against ``repro.workloads.generate._kernels()`` — f32
  rtol 1e-6, lengths exact.  (No torch generator draws JAX's numbers, so
  the draws themselves are not compared; within the port the same seed
  gives the same workload bit for bit.)
* Numpy modules: DAG helpers, arrivals and the wfcommons import/export of
  ``tests/data/mini_wfcommons.json`` equal the reference's exactly.
* Carried traces: ``load_workflow_trace`` of reference scenarios gives
  ``to_jobs`` plans identical to the reference's.
"""

import dataclasses
import os
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.workloads import arrivals as arrivals_ref
from repro.workloads import generate as gen_ref
from repro.workloads import scenarios as scen_ref
from repro.workloads import suite as suite_ref
from repro.workloads import wfc as wfc_ref
from repro_torch.workloads import (
    SCENARIOS,
    FamilyRecipe,
    arrivals,
    generate,
    load_workflow_trace,
    make_suite,
    run_suite,
    scenarios,
    suite_table,
    synthesize,
    trace_state,
    wfc,
)

DATA = os.path.join(os.path.dirname(__file__), "data", "mini_wfcommons.json")
RTOL = 1e-6


def _recipes():
    """Every recipe of the catalog (the shapes, sigmas and dts it uses)."""
    out = []
    for name in scen_ref.SCENARIOS:
        for r in _catalog_recipes(name):
            out.append((name, r))
    return out


def _catalog_recipes(name):
    """The reference scenario's recipes, caught on their way into the
    catalog's ``synthesize``."""
    seen = []
    keep = scen_ref.synthesize

    def spy(recipes, counts, seed=0, **kw):
        seen.extend(recipes)
        return keep(recipes, counts, seed, **kw)

    scen_ref.synthesize = spy
    try:
        scen_ref.get(name, n_tasks=8)
    finally:
        scen_ref.synthesize = keep
    return seen


RECIPES = _recipes()


# ------------------------------------------------------------- shape math
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("i", range(len(RECIPES)),
                         ids=[f"{s}-{r.name}-{r.dt}" for s, r in RECIPES])
def test_scalars_from_reference_normals(i, seed):
    _, r = RECIPES[i]
    port_r = FamilyRecipe(**dataclasses.asdict(r))
    n = 97
    scalars_fn, _ = gen_ref._kernels()
    fkey = jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), i),
        zlib.crc32(f"{r.name}/{r.shape}/{r.dt}".encode()) % (2 ** 31))
    want = [np.asarray(x) for x in scalars_fn(
        fkey, r.input_median_gb, r.input_sigma, r.dur_base, r.dur_per_gb,
        r.dur_sigma, r.mem_base, r.mem_per_gb, r.mem_sigma, n=n)]
    z = np.stack([np.asarray(jax.random.normal(k, (n,)))
                  for k in jax.random.split(fkey, 3)])
    got = [x.numpy() for x in generate.scalars_from_normals(
        torch.from_numpy(z), port_r)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=RTOL)
    lengths = lambda dur: np.maximum(  # noqa: E731
        np.round(np.asarray(dur, np.float64) / r.dt), 2.0)
    np.testing.assert_array_equal(lengths(got[1]), lengths(want[1]))


def _lane_params(rng, B):
    shape_id = rng.integers(0, 5, B).astype(np.float32)
    level = rng.uniform(0.2, 6.0, B).astype(np.float32)
    lengths = rng.integers(0, 200, B)
    lengths[:3] = (0, 1, 2)
    params = np.stack([rng.uniform(0.0, 0.7, B), rng.uniform(0.0, 1.0, B),
                       rng.uniform(0.5, 6.0, B)], axis=1).astype(np.float32)
    params[::7, 2] = 0.0  # cycles / phases below 1 clamp to 1
    noise = rng.choice([0.0, 0.01, 0.05], B).astype(np.float32)
    return shape_id, level, lengths, params, noise


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_traces_from_reference_normals(seed):
    rng = np.random.default_rng(seed)
    B, T = 64, 256
    shape_id, level, lengths, params, noise = _lane_params(rng, B)
    _, traces_fn = gen_ref._kernels()
    key = jax.random.PRNGKey(seed)
    f32 = lambda a: jax.numpy.asarray(a, np.float32)  # noqa: E731
    want = np.asarray(traces_fn(
        key, f32(shape_id), f32(level), jax.numpy.asarray(lengths),
        f32(params[:, 0]), f32(params[:, 1]), f32(params[:, 2]), f32(noise),
        T=T))
    z = np.asarray(jax.random.normal(key, (B, T), dtype=np.float32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got = generate.traces_from_normals(
        t(z), t(shape_id), t(level), t(lengths), t(params[:, 0]),
        t(params[:, 1]), t(params[:, 2]), t(noise)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert ((got == 0) == (want == 0)).all()


# -------------------------------------------------------- port determinism
def test_same_seed_bitwise_identical():
    a = scenarios.get("heavy_tail", n_tasks=120, seed=5, device="cpu")
    b = scenarios.get("heavy_tail", n_tasks=120, seed=5, device="cpu")
    c = scenarios.get("heavy_tail", n_tasks=120, seed=6, device="cpu")
    for x, y in zip(a.batch.buckets, b.batch.buckets):
        np.testing.assert_array_equal(x.idx, y.idx)
        assert np.array_equal(x.mems, y.mems)
        assert torch.equal(x.dmems, y.dmems)
        assert torch.equal(x.dsummem, y.dsummem)
    np.testing.assert_array_equal(a.input_gb, b.input_gb)
    assert not np.array_equal(a.input_gb, c.input_gb)


def test_shapes_and_scaling_have_their_structure():
    recipes = [FamilyRecipe(s, shape=s, noise=0.0, dur_sigma=0.0,
                            mem_sigma=0.0, dur_base=100.0, dur_per_gb=0.0)
               for s in generate.SHAPES]
    wf = synthesize(recipes, 4, seed=0, device="cpu")
    for i in range(wf.B):
        m, s = wf.mem(i), wf.families[i]
        assert (m > 0).all() and len(m) == 100
        if s == "plateau":
            assert np.ptp(m) == 0
        elif s in ("ramp", "phases"):
            assert (np.diff(m) >= 0).all() and m[-1] > m[0]
        elif s == "spike":
            assert m.max() > 1.9 * np.median(m)


def test_carried_state_round_trip_is_exact():
    wf = scenarios.get("deep_chain", n_tasks=80, seed=2, device="cpu")
    back = load_workflow_trace(trace_state(wf), device="cpu")
    assert back.parents == wf.parents and back.task_ids == wf.task_ids
    for x, y in zip(wf.batch.buckets, back.batch.buckets):
        assert torch.equal(x.dmems, y.dmems)
        assert torch.equal(x.dsummem, y.dsummem)
        assert torch.equal(x.dlengths, y.dlengths)


def test_catalog_matches_reference():
    assert list(SCENARIOS) == list(scen_ref.SCENARIOS)
    for name, spec in scen_ref.SCENARIOS.items():
        assert SCENARIOS[name].default_n == spec.default_n
        assert SCENARIOS[name].description == spec.description
        assert scenarios._split_counts(37, (3, 2, 4, 1)) == \
            scen_ref._split_counts(37, (3, 2, 4, 1))
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get("nope", device="cpu")


@pytest.mark.parametrize("name", list(scen_ref.SCENARIOS))
def test_scenario_structure_matches_reference(name):
    """Same families, counts, dts and DAG as the reference (only the
    normals differ)."""
    ref = scen_ref.get(name, n_tasks=70, seed=1)
    got = scenarios.get(name, n_tasks=70, seed=1, device="cpu")
    assert got.families == ref.families and got.task_ids == ref.task_ids
    assert got.parents == ref.parents
    np.testing.assert_array_equal(got.dts, ref.dts)
    assert got.default_limits == ref.default_limits
    assert (got.lengths >= 2).all()


# ------------------------------------------------------------ numpy modules
@pytest.mark.parametrize("B", [1, 9, 130, 300])
def test_dag_helpers_identical(B):
    assert generate.chain_parents(B, 4) == gen_ref.chain_parents(B, 4)
    assert generate.fanout_parents(B, 8) == gen_ref.fanout_parents(B, 8)
    assert generate.barrier_parents(B, 5) == gen_ref.barrier_parents(B, 5)
    for seed in (0, 7):
        assert generate.layered_parents(B, seed, 64, 3) == \
            gen_ref.layered_parents(B, seed, 64, 3)


@pytest.mark.parametrize("seed", [0, 1, 4])
def test_arrivals_identical(seed):
    parents = gen_ref.layered_parents(200, seed=seed, layer_width=32)
    for p in (None, parents):
        np.testing.assert_array_equal(
            arrivals.poisson_arrivals(200, 0.5, seed, p),
            arrivals_ref.poisson_arrivals(200, 0.5, seed, p))
        np.testing.assert_array_equal(
            arrivals.diurnal_arrivals(200, 0.5, 600.0, 0.8, seed, p),
            arrivals_ref.diurnal_arrivals(200, 0.5, 600.0, 0.8, seed, p))
    times = np.random.default_rng(seed).uniform(5, 50, 300)
    np.testing.assert_array_equal(
        arrivals.trace_arrivals(200, times, parents),
        arrivals_ref.trace_arrivals(200, times, parents))
    with pytest.raises(ValueError, match="rate > 0"):
        arrivals.poisson_arrivals(3, 0.0)


def test_wfc_import_identical():
    ref = wfc_ref.load_instance(DATA)
    got = wfc.load_instance(DATA, device="cpu")
    for field in ("task_ids", "families", "parents", "default_limits",
                  "name"):
        assert getattr(got, field) == getattr(ref, field), field
    for field in ("lengths", "input_gb", "dts"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(ref, field))
    for i in range(ref.B):  # plateau traces, no jitter: exact
        np.testing.assert_array_equal(got.mem(i), ref.mem(i))
    np.testing.assert_array_equal(got.peaks(), ref.peaks())
    assert wfc.export_instance(got) == wfc_ref.export_instance(ref)
    again = wfc.import_instance(wfc.export_instance(got), device="cpu")
    assert again.parents == got.parents
    np.testing.assert_array_equal(again.peaks(), got.peaks())


@pytest.mark.parametrize("ids,parents", [
    (["a", "b", "a"], [[], [], []]),
    (["a", "b"], [["a"], ["b"]]),
    (["a", "b"], [[], ["zz"]]),
    (["a", "b", "c"], [["c"], ["a"], ["b"]]),
])
def test_validate_dag_ids_same_errors(ids, parents):
    with pytest.raises(ValueError) as want:
        wfc_ref.validate_dag_ids(ids, parents)
    with pytest.raises(ValueError) as got:
        wfc.validate_dag_ids(ids, parents)
    assert str(got.value) == str(want.value)


# ----------------------------------------------------------- carried traces
@pytest.mark.parametrize("name,under", [
    ("workload_replay", 0.2), ("burst_arrival", 0.15), ("heavy_tail", 0.0),
    ("hetero_dt", 0.1)])
def test_carried_trace_gives_reference_jobs(name, under):
    ref = scen_ref.get(name, n_tasks=90, seed=3)
    ref = arrivals_ref.with_arrivals(ref, arrivals_ref.poisson_arrivals(
        ref.B, 0.5, seed=3, parents=ref.parents))
    got = load_workflow_trace(ref, device="cpu")
    want_jobs = ref.to_jobs(under_frac=under, seed=3)
    got_jobs = got.to_jobs(under_frac=under, seed=3)
    for a, b in zip(got_jobs, want_jobs):
        assert (a.jid, a.family, a.input_gb, a.dt, a.est_runtime,
                a.parents, a.release_time) == \
            (b.jid, b.family, b.input_gb, b.dt, b.est_runtime, b.parents,
             b.release_time)
        np.testing.assert_array_equal(a.mem, b.mem)
        np.testing.assert_array_equal(a.plan.starts, b.plan.starts)
        np.testing.assert_array_equal(a.plan.peaks, b.plan.peaks)
    np.testing.assert_array_equal(got.peaks(), ref.peaks())
    np.testing.assert_array_equal(got.runtimes(), ref.runtimes())
    for x, y in zip(got.batch.buckets, ref.batch.buckets):
        np.testing.assert_array_equal(x.dsummem.numpy(),
                                      np.asarray(y.dsummem)[:len(y.idx)])


def test_carried_trace_split_matches_reference():
    ref = scen_ref.get("heavy_tail", n_tasks=60, seed=0)
    got = load_workflow_trace(ref, device="cpu")
    tr_r, te_r = ref.to_workflow().split(4, 0.5)
    tr_p, te_p = got.to_workflow().split(4, 0.5)
    for a, b in ((tr_p, tr_r), (te_p, te_r)):
        assert list(a) == list(b)
        for f in a:
            assert [e.input_gb for e in a[f]] == [e.input_gb for e in b[f]]


def test_release_order_checker_identical():
    jobs = scen_ref.get("deep_chain", n_tasks=40, seed=0).to_jobs()
    bad = [(0.0, 0, j.jid) for j in jobs]
    with pytest.raises(AssertionError) as want:
        gen_ref.assert_release_order(jobs, bad)
    with pytest.raises(AssertionError) as got:
        generate.assert_release_order(jobs, bad)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------------- suite
def test_suite_grid_and_table_match_reference():
    args = (("burst_arrival", "wide_fanout"), ("none", "diurnal"),
            ("storm", "rack"))
    assert [c.name for c in make_suite(*args, seeds=(0, 1))] == \
        [c.name for c in suite_ref.make_suite(*args, seeds=(0, 1))]
    rows = run_suite(make_suite(("deep_chain",), ("poisson",),
                                ("churn",)), n_tasks=48, device="cpu",
                     check_oracle=True)
    assert suite_table(rows) == suite_ref.suite_table(rows)
    assert rows[0]["finished"] + rows[0]["unschedulable"] \
        + rows[0]["starved"] == rows[0]["jobs"]
