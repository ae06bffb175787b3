"""``launch.train.train`` on its local mesh, on the CPU.

* Over 4 gloo processes (local mesh ``(4, 1)``: "batch" and "embed_fsdp"
  on ``data``, data parallel with FSDP parameters) ``train`` gives one
  process's losses and final parameters and AdamW moments to 1e-5 of each
  leaf's scale, for the qwen3-1.7b and zamba2-2.7b smoke configs in
  float32 (``device="cpu"``, 3 steps of 8 x 32).
* Killed at step 2 and resumed, the 4-process run is bitwise the
  uninterrupted one (losses and the final checkpoint), and its step-2
  checkpoint resumes in one process to the same losses and parameters.
* The one-process mesh run, started from the reference's initial
  parameters, gives the reference's ``repro.launch.train.train`` losses
  and final checkpoint.
* No process group outlives ``train``: a dry run's fake world starts
  right after it, whether it finished, was killed or raised; a group the
  caller made is left as it is.

The multi-process cases run in a subprocess with a timeout, as
``tests/test_torch_moe_distributed.py``; the processes rendezvous on a
free localhost port.
"""

import dataclasses
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro import models as jmodels
from repro.launch import train as jtrain_mod
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import load_jax_params
from repro_torch.optim import cosine_schedule

STEPS, SEQ, BATCH = 3, 32, 8
ARCHS = ["qwen3-1.7b", "zamba2-2.7b"]

_WORKERS = textwrap.dedent('''
import dataclasses, os, socket, sys, traceback
import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, port, arch, root):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        from repro_torch.configs import smoke_config
        from repro_torch.launch import train as train_mod
        train_mod.smoke_config = lambda a: dataclasses.replace(
            smoke_config(a), dtype="float32")
        place, seen = train_mod.place_params, set()

        def spy(model, *args):
            place(model, *args)
            seen.update(str(p.placements) for p in model.parameters())
        train_mod.place_params = spy
        kw = dict(steps=%(steps)d, seq=%(seq)d, batch=%(batch)d,
                  ckpt_every=2, monitor=False, device="cpu")
        full = train_mod.train(arch, ckpt_dir=os.path.join(root, "full"),
                               **kw)
        killed = train_mod.train(arch, ckpt_dir=os.path.join(root, "kill"),
                                 kill_at_step=2, **kw)
        if rank == 0:  # the step-2 checkpoint, kept for a one-process resume
            shutil_copy(os.path.join(root, "kill"),
                        os.path.join(root, "kill_at_2"))
        dist.barrier()
        resumed = train_mod.train(arch, ckpt_dir=os.path.join(root, "kill"),
                                  resume=True, **kw)
        assert dist.is_initialized()  # the caller's group is left as it is
        if rank == 0:
            np.savez(os.path.join(root, "losses.npz"),
                     full=full["losses"], killed=killed["losses"],
                     resumed=resumed["losses"],
                     status=[full["status"], killed["status"],
                             resumed["status"]],
                     placements=" ".join(sorted(seen)))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def shutil_copy(src, dst):
    import shutil
    shutil.copytree(src, dst)


if __name__ == "__main__":
    arch, root = sys.argv[1], sys.argv[2]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(4, port, arch, root), nprocs=4,
                       start_method="spawn")
    print("WORKERS-OK")
''') % dict(steps=STEPS, seq=SEQ, batch=BATCH)


def _f32_smoke(arch):
    return dataclasses.replace(configs.smoke_config(arch), dtype="float32")


def _ckpt(path, step):
    mgr = CheckpointManager(path)
    assert step in mgr.all_steps(), (path, mgr.all_steps())
    with np.load(os.path.join(mgr._step_dir(step), "proc0.npz")) as data:
        return dict(data)


def _assert_close(got, want, rel=1e-5):
    """Every leaf within ``rel`` of its scale (its largest |value|, at
    least 1)."""
    assert set(got) == set(want)
    bad = []
    for key, w in want.items():
        scale = max(float(np.abs(w).max(initial=0.0)), 1.0)
        err = float(np.abs(got[key] - w).max(initial=0.0))
        if err > rel * scale:
            bad.append((key, err, scale))
    assert not bad, bad


@pytest.fixture(scope="module", params=ARCHS)
def four(request, tmp_path_factory):
    """The 4-process runs of one arch: uninterrupted, killed at step 2,
    resumed; their losses and checkpoint directories."""
    arch = request.param
    root = tmp_path_factory.mktemp(f"mesh4_{arch}")
    script = root / "workers.py"
    script.write_text(_WORKERS)
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), arch, str(root)],
                       cwd=os.getcwd(), env=env, capture_output=True,
                       text=True, timeout=540)
    assert "WORKERS-OK" in r.stdout, r.stdout + r.stderr
    with np.load(root / "losses.npz") as data:
        out = {k: data[k].tolist() for k in data}
    out["placements"] = str(out["placements"])
    return arch, root, out


def _one_process(arch, ckpt_dir, monkeypatch, **kw):
    monkeypatch.setattr(train_mod, "smoke_config", _f32_smoke)
    return train_mod.train(arch, steps=STEPS, seq=SEQ, batch=BATCH,
                           ckpt_every=2, monitor=False, device="cpu",
                           ckpt_dir=str(ckpt_dir), **kw)


def test_four_processes_equal_one(four, tmp_path, monkeypatch):
    arch, root, out = four
    assert out["status"] == ["done", "killed", "done"]
    assert "Shard(dim=" in out["placements"]  # FSDP over "data"
    one = _one_process(arch, tmp_path / "one", monkeypatch)
    assert len(out["full"]) == STEPS
    np.testing.assert_allclose(out["full"], one["losses"], rtol=0,
                               atol=1e-5 * max(max(one["losses"]), 1.0))
    for step in (2, STEPS):
        _assert_close(_ckpt(str(root / "full"), step),
                      _ckpt(str(tmp_path / "one"), step))


def test_four_process_kill_and_resume_is_bitwise(four, tmp_path,
                                                 monkeypatch):
    arch, root, out = four
    assert out["killed"] == out["full"][:2]
    assert out["resumed"] == out["full"][2:]
    full, resumed = (_ckpt(str(root / d), STEPS) for d in ("full", "kill"))
    assert set(full) == set(resumed)
    for key in full:
        np.testing.assert_array_equal(resumed[key], full[key], err_msg=key)
    # the 4-process checkpoint of step 2 resumes in one process
    ckpt = tmp_path / "from4"
    shutil.copytree(root / "kill_at_2", ckpt)
    one = _one_process(arch, ckpt, monkeypatch, resume=True)
    np.testing.assert_allclose(one["losses"], out["full"][2:], rtol=0,
                               atol=1e-5 * max(max(out["full"]), 1.0))
    _assert_close(_ckpt(str(ckpt), STEPS), full)


def test_one_process_mesh_equals_the_reference(tmp_path, monkeypatch):
    """Both loops from the reference's initial parameters (qwen3-1.7b
    smoke in float32, 3 steps): losses to 1e-5 and the final parameters to
    1e-3 of the largest distance AdamW can move them (an element whose
    gradient is ~0 steps either way from a tiny difference in it, as
    ``tests/test_torch_train.py`` holds three steps)."""
    arch = "qwen3-1.7b"
    f32 = dict(dtype="float32")
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch), **f32)
    monkeypatch.setattr(jtrain_mod, "smoke_config", lambda a: jcfg)
    kw = dict(steps=STEPS, seq=SEQ, batch=BATCH, ckpt_every=100,
              monitor=False)
    want = jtrain_mod.train(arch, ckpt_dir=str(tmp_path / "ref"), **kw)
    jparams = jax.tree.map(np.asarray, jmodels.init_params(
        dataclasses.replace(jcfg, remat="none"), jax.random.PRNGKey(0)))
    monkeypatch.setattr(train_mod, "smoke_config", _f32_smoke)
    monkeypatch.setattr(train_mod, "init_params",
                        lambda cfg, gen, device: load_jax_params(
                            cfg, jparams, device=device))
    got = train_mod.train(arch, ckpt_dir=str(tmp_path / "port"),
                          device="cpu", **kw)
    np.testing.assert_allclose(got["first_loss"], want["first_loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-5)
    lr = cosine_schedule(peak_lr=3e-3, warmup_steps=1, total_steps=STEPS)
    moved = sum(lr(s) for s in range(STEPS))
    ref, port = _ckpt(str(tmp_path / "ref"), STEPS), \
        _ckpt(str(tmp_path / "port"), STEPS)
    assert set(ref) == set(port)
    for key in ref:
        if key.startswith("params/"):
            np.testing.assert_allclose(port[key], ref[key], rtol=0,
                                       atol=1e-3 * moved, err_msg=key)


def _fake_world_starts():
    with mesh_mod.fake_world():
        mesh = mesh_mod.make_mesh((4, 2), ("data", "model"))
        assert tuple(mesh.shape) == (4, 2)
    assert not dist.is_initialized()


def test_no_group_outlives_train(tmp_path, monkeypatch):
    kw = dict(steps=2, seq=16, batch=2, monitor=False, device="cpu")
    assert not dist.is_initialized()
    assert train_mod.train("qwen3-1.7b", **kw)["status"] == "done"
    _fake_world_starts()
    killed = train_mod.train("qwen3-1.7b", ckpt_dir=str(tmp_path),
                             kill_at_step=1, ckpt_every=1, **kw)
    assert killed["status"] == "killed"
    _fake_world_starts()

    def boom(*a, **k):
        raise KeyError("data")
    monkeypatch.setattr(train_mod, "host_batch", boom)
    with pytest.raises(KeyError, match="data"):
        train_mod.train("qwen3-1.7b", **kw)
    _fake_world_starts()


def test_train_leaves_the_callers_group():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        out = train_mod.train("zamba2-2.7b", steps=1, seq=16, batch=2,
                              monitor=False, device="cpu")
        assert out["status"] == "done" and dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_parameters_are_dtensors_on_the_local_mesh(monkeypatch):
    """The loop trains DTensor parameters and moments on a (1, 1) mesh of
    the process's device, and its batch is laid out on "batch"."""
    from torch.distributed.tensor import DTensor
    seen = {}
    make = train_mod.make_train_step

    def spy(*a, **k):
        step_fn = make(*a, **k)

        def step(model, opt, batch, i):
            seen["params"] = list(model.parameters())
            seen["moments"] = list(opt["m"].values())
            seen["batch"] = list(batch.values())
            return step_fn(model, opt, batch, i)
        return step
    monkeypatch.setattr(train_mod, "make_train_step", spy)
    train_mod.train("olmoe-1b-7b", steps=1, seq=16, batch=2, monitor=False,
                    device="cpu")
    for t in seen["params"] + seen["moments"] + seen["batch"]:
        assert isinstance(t, DTensor)
        assert tuple(t.device_mesh.shape) == (1, 1)
        assert t.device_mesh.device_type == "cpu"
