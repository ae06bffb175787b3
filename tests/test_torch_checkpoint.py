"""The port's data pipeline, checkpoints and training loop against the
reference package, on the CPU.

* ``host_batch`` is bitwise the reference's for every family's inputs.
* ``CheckpointManager`` passes the reference's own checkpoint cases
  (``tests/test_substrate.py::TestCheckpoint``: round trip, keep / prune,
  async, atomic), and a checkpoint moves both ways: one that the reference
  wrote restores into the port's model and AdamW state, and one that the
  port wrote restores through the reference's manager into the reference's
  trees, bitwise.
* ``launch.train.train(..., device="cpu")`` killed mid-run and resumed
  gives losses bitwise equal to an uninterrupted run, as the reference's
  ``examples/fault_tolerance.py`` shows for its own loop.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.data import host_batch as j_host_batch
from repro.optim import adamw_init as j_adamw_init
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import SyntheticLMDataset, host_batch
from repro_torch.launch.train import load_train_state, train, train_state
from repro_torch.models import init_params, load_jax_params
from repro_torch.optim import adamw_init


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3-8b", "qwen2-vl-72b",
                                  "hubert-xlarge"])
def test_host_batch_is_bitwise_the_reference(arch):
    jc, tc = jconfigs.smoke_config(arch), configs.smoke_config(arch)
    for step, shard, shards in ((0, 0, 1), (7, 1, 2), (123, 3, 4)):
        got = host_batch(tc, 32, 8, step, seed=5, shard=shard,
                         num_shards=shards)
        want = j_host_batch(jc, 32, 8, step, seed=5, shard=shard,
                            num_shards=shards)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert SyntheticLMDataset(vocab=16, seq_len=4, global_batch=2).batch(
        0)["tokens"].shape == (2, 4)


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "nested": {"b": torch.ones(4)}}
        mgr.save(10, tree, meta={"loss": 1.5})
        out = mgr.restore(10, tree)
        np.testing.assert_array_equal(out["a"], tree["a"].numpy())
        np.testing.assert_array_equal(out["nested"]["b"], np.ones(4))
        assert mgr.meta(10)["loss"] == 1.5

    def test_keep_prunes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        tree = {"x": torch.zeros(2)}
        for s in (1, 2, 3, 4):
            mgr.save(s, tree)
        assert mgr.all_steps() == [3, 4]

    def test_async_save_snapshots_before_returning(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        x = torch.arange(8)
        mgr.save_async(7, {"x": x})
        x.add_(100)  # the next step writes in place: the snapshot holds
        mgr.wait()
        assert mgr.latest_step() == 7
        np.testing.assert_array_equal(mgr.restore(7, {"x": (8,)})["x"],
                                      np.arange(8))

    def test_atomic_no_partial_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.zeros(2)})
        names = os.listdir(tmp_path)
        assert all(not n.endswith(".tmp0") for n in names)
        os.makedirs(tmp_path / "step_00000009.tmp0")  # a killed writer's
        assert mgr.latest_step() == 1

    def test_restore_checks_shapes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.zeros(2)})
        with pytest.raises(ValueError, match="x"):
            mgr.restore(1, {"x": (3,)})


def _smoke(arch="zamba2-2.7b"):
    jc = dataclasses.replace(jconfigs.smoke_config(arch), dtype="float32")
    tc = dataclasses.replace(configs.smoke_config(arch), dtype="float32")
    return jc, tc


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def _assert_same(got, want):
    got = dict(_leaves(got))
    for name, w in _leaves(want):
        g = got.pop(name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got, sorted(got)


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llama3-8b"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, arch):
    jc, tc = _smoke(arch)
    params = jmodels.init_params(jc, jax.random.PRNGKey(1))
    opt = j_adamw_init(params)
    rng = np.random.default_rng(2)
    opt = {"m": jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
               np.float32), opt["m"]),
           "v": jax.tree.map(lambda a: rng.random(a.shape).astype(
               np.float32), opt["v"]),
           "count": np.int32(17)}
    JCheckpointManager(str(tmp_path), process_index=0).save(
        5, {"params": params, "opt": opt}, meta={"loss": 2.0})

    model = init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    named = dict(model.named_parameters())
    popt = adamw_init(named)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 5 and mgr.meta(5)["loss"] == 2.0
    load_train_state(tc, mgr.restore(
        5, train_state(tc, named, popt, shapes=True)), named, popt)
    _assert_same(train_state(tc, named, popt),
                 jax.tree.map(np.asarray, {"params": params, "opt": opt}))
    assert int(popt["count"]) == 17
    # the restored weights are the reference's: the model is load_jax_params'
    carried = load_jax_params(tc, jax.tree.map(np.asarray, params),
                              device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              carried.named_parameters()):
        assert torch.equal(a, b), n


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jc, tc = _smoke()
    model = init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    named = dict(model.named_parameters())
    opt = adamw_init(named)
    for t in list(opt["m"].values()) + list(opt["v"].values()):
        t.uniform_()
    opt["count"].fill_(4)
    state = train_state(tc, named, opt)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(9, state)
    mgr.wait()
    jmgr = JCheckpointManager(str(tmp_path), process_index=0)
    jparams = jmodels.init_params(jc, jax.random.PRNGKey(0))
    restored = jmgr.restore(jmgr.latest_step(),
                            {"params": jparams, "opt": j_adamw_init(jparams)})
    _assert_same(restored, state)


def test_train_kill_and_resume_is_bitwise(tmp_path):
    """Checkpoints every 3 steps, killed at step 5, resumed from step 3:
    the resumed losses are bitwise the uninterrupted run's."""
    kw = dict(steps=8, seq=32, batch=2, ckpt_every=3, monitor=False,
              device="cpu")
    full = train("zamba2-2.7b", **kw)
    assert full["status"] == "done" and len(full["losses"]) == 8
    assert all(np.isfinite(full["losses"]))
    ckpt = str(tmp_path / "ckpt")
    killed = train("zamba2-2.7b", ckpt_dir=ckpt, kill_at_step=5, **kw)
    assert killed["status"] == "killed" and killed["step"] == 5
    assert killed["losses"] == full["losses"][:5]
    resumed = train("zamba2-2.7b", ckpt_dir=ckpt, resume=True, **kw)
    assert resumed["status"] == "done"
    assert resumed["losses"] == full["losses"][3:]
    assert CheckpointManager(ckpt).latest_step() == 8


def test_train_cli_trains_a_dense_model(tmp_path):
    out = train("qwen3-1.7b", steps=6, seq=32, batch=2, log_every=3,
                ckpt_dir=str(tmp_path), ckpt_every=2, device="cpu")
    assert out["status"] == "done" and out["slow_steps"] >= 0
    assert out["rss_trace_gb"] and len(out["step_s"]) == 6
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4, 6]
