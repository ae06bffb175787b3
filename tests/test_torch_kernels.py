"""The port's wastage kernels against the reference's Pallas kernels.

On the CPU the wrappers (``repro_torch.kernels.wastage.ops``) take the plain
PyTorch version, which must compute what the Pallas kernel computes: the
same seeded inputs go through ``repro.kernels.wastage.ops`` in interpret
mode, through the numpy oracles, and through the port.  ``viol`` must be
exact; ``w_succ`` / ``w_kill`` within rtol 1e-4 / atol 1e-2 (the reference
tests' tolerance: float32 sums in another order).

The CUDA kernel itself has no CPU mode: the ``cuda``-marked test holds it
against the plain version on the card and skips here.
"""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro.core.wastage import oom_probe_ref, wastage_eval_ref
from repro.kernels.wastage.ops import oom_probe as oom_probe_pallas
from repro.kernels.wastage.ops import wastage_eval as wastage_eval_pallas
from repro_torch.kernels import build
from repro_torch.kernels.wastage import ops, ref

TOL = dict(rtol=1e-4, atol=1e-2)


def _case(seed, B, T, k, dt=1.0, *, sentinel=False, monotone=True):
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


def _check_probe(starts, peaks, mems, lengths, dt):
    viol, w_succ, w_kill = (t.numpy() for t in ops.oom_probe(
        *_torch(starts, peaks, mems, lengths), dt=dt))
    pv, ps, pk = (np.asarray(x) for x in oom_probe_pallas(
        starts, peaks, mems, lengths, dt=dt, interpret=True))
    rv, rs, rk = oom_probe_ref(starts, peaks, mems, lengths, dt)
    assert viol.dtype == np.int32
    np.testing.assert_array_equal(viol, pv)
    np.testing.assert_array_equal(viol, rv)
    for got, want in ((w_succ, ps), (w_succ, rs), (w_kill, pk), (w_kill, rk)):
        np.testing.assert_allclose(got, want, **TOL)


class TestOOMProbe:
    @pytest.mark.parametrize("B,T,k", [(8, 512, 4), (16, 700, 8), (3, 64, 1)])
    def test_sweep(self, B, T, k):
        _check_probe(*_case(B * T, B, T, k), 1.0)

    @pytest.mark.parametrize("dt", [0.5, 1.0, 2.5])
    def test_dt_sweep(self, dt):
        # T = 700 is not a multiple of any block size
        _check_probe(*_case(7, 12, 700, 4, dt), dt)

    def test_sentinel_padded_slots_inactive(self):
        _check_probe(*_case(8, 4, 128, 4, sentinel=True), 1.0)

    @pytest.mark.parametrize("k", [1, 4, 8])
    def test_all_fit_and_zero_plan(self, k):
        starts, _, mems, lengths = _case(9 + k, 6, 96, k)
        fat = np.full((6, k), float(mems.max()) + 1.0, np.float32)
        viol, _, w_kill = ops.oom_probe(*_torch(starts, fat, mems, lengths))
        assert (viol.numpy() == -1).all() and (w_kill.numpy() == 0).all()
        _check_probe(starts, fat, mems, lengths, 1.0)
        zero = np.zeros((6, k), np.float32)
        viol, _, _ = ops.oom_probe(*_torch(starts, zero, mems, lengths))
        np.testing.assert_array_equal(viol.numpy(), np.zeros(6, np.int32))
        _check_probe(starts, zero, mems, lengths, 1.0)

    def test_duplicate_starts_last_wins(self):
        starts = np.asarray([[0.0, 5.0, 5.0, 9.0]], np.float32)
        peaks = np.asarray([[1.0, 2.0, 3.0, 4.0]], np.float32)
        alloc = ref.alloc_grid(*_torch(starts, peaks), 12, 1.0).numpy()[0]
        np.testing.assert_array_equal(alloc, [1] * 5 + [3] * 4 + [4] * 3)


class TestWastageEval:
    @pytest.mark.parametrize("B,T,k", [(8, 512, 4), (16, 700, 8), (3, 64, 1)])
    def test_sweep(self, B, T, k):
        starts, peaks, mems, lengths = _case(B + T, B, T, k)
        got = ops.wastage_eval(*_torch(starts, peaks, mems, lengths)).numpy()
        want = np.asarray(wastage_eval_pallas(starts, peaks, mems, lengths,
                                              dt=1.0, interpret=True))
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(
            got, wastage_eval_ref(starts, peaks, mems, lengths, 1.0), **TOL)

    def test_non_monotone_plans(self):
        """k-Segments plans can step down; the plain version must match."""
        starts, peaks, mems, lengths = _case(12, 6, 256, 4, monotone=False)
        got = ops.wastage_eval(*_torch(starts, peaks, mems, lengths)).numpy()
        want = np.asarray(wastage_eval_pallas(starts, peaks, mems, lengths,
                                              dt=1.0, interpret=True))
        np.testing.assert_allclose(got, want, **TOL)


class TestWrapperContract:
    def test_rejects_wrong_dtype_shape_and_layout(self):
        s, p, m, n = _torch(*_case(13, 4, 64, 2))
        with pytest.raises(TypeError):
            ops.oom_probe(s.double(), p, m, n)
        with pytest.raises(TypeError):
            ops.oom_probe(s, p, m, n.long())
        with pytest.raises(ValueError):
            ops.oom_probe(s[:3], p, m, n)
        with pytest.raises(ValueError):
            ops.oom_probe(s, p, m.t().contiguous().t(), n)


class TestBuildDir:
    def test_library_goes_under_the_checkout(self):
        root = pathlib.Path(__file__).resolve().parents[1]
        assert build.build_dir() == root / "build" / "repro_torch_kernels"

    def test_outside_a_checkout_raises(self, tmp_path):
        """A copy of build.py outside a ``<root>/src`` checkout (as after a
        plain install) refuses to pick a build directory."""
        dst = tmp_path / "site" / "repro_torch" / "kernels"
        dst.mkdir(parents=True)
        shutil.copy(build.__file__, dst / "build.py")
        spec = importlib.util.spec_from_file_location("_b", dst / "build.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="source checkout"):
            mod.build_dir()


@pytest.mark.cuda
class TestKernelOnCard:
    def test_kernel_matches_plain(self):
        if not torch.cuda.is_available():
            pytest.skip("the CUDA kernel has no CPU mode; needs a CUDA card")
        for seed, (B, T, k, dt) in enumerate([(8, 512, 4, 1.0),
                                              (16, 700, 8, 2.5),
                                              (3, 64, 1, 0.5)]):
            arrs = tuple(t.cuda() for t in _torch(*_case(seed, B, T, k, dt)))
            before = ops.LAUNCHES["oom_probe"]
            viol, ws, wk = ops.oom_probe(*arrs, dt=dt)
            assert ops.LAUNCHES["oom_probe"] == before + 1
            rv, rs, rk = ref.oom_probe(*arrs, dt)
            assert torch.equal(viol, rv)
            torch.testing.assert_close(ws, rs, **TOL)
            torch.testing.assert_close(wk, rk, **TOL)
            torch.testing.assert_close(ops.wastage_eval(*arrs, dt=dt),
                                       ref.wastage_eval(*arrs, dt), **TOL)
