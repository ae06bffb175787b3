"""The expert-parallel MoE form and the sharded model over real process
groups: 8 CPU processes (gloo) on a (4, 2) ("data", "model") mesh.

* ``moe_block_local`` on DTensors (tokens batch-sharded, weights laid out
  by the reference's axes: experts over ``model``, FSDP over ``data``)
  equals the port's one-process ``moe_block`` and the reference's
  ``moe_block`` to 1e-5 (``tests/test_moe_distributed.py``'s data), with
  finite input gradients equal to ``moe_block``'s.
* Small olmoe-style (MQA: its one KV head does not divide the ``model``
  axis, so prefill attention splits query heads and decode attention runs
  flash-decoding over a sequence-sharded cache) and zamba2-style (Mamba2
  blocks and the shared attention block) models give the one-process
  logits and caches over prefill and two decode steps, and their training
  loss and gradients, to 1e-5 of each tensor's scale.

Each runs in a subprocess with a timeout, as the reference's test does;
the processes rendezvous on a free localhost port.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest

from repro.models.moe import moe_block as jmoe_block

_WORKERS = textwrap.dedent('''
import os, socket, sys, traceback
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def moe_case(rank):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.partitioning import (default_rules,
                                                 mesh_context, sharding_for)
    from repro_torch.models.moe import moe_block, moe_block_local
    mesh = make_mesh((4, 2), ("data", "model"))
    rng = np.random.default_rng(7)
    d, E, ff = 32, 8, 64
    x = torch.tensor(rng.standard_normal((8, 16, d)), dtype=torch.float32)
    router = torch.tensor(rng.standard_normal((d, E)) * 0.1,
                          dtype=torch.float32)
    wg, wu = (torch.tensor(rng.standard_normal((E, d, ff)) * 0.05,
                           dtype=torch.float32) for _ in range(2))
    wd = torch.tensor(rng.standard_normal((E, ff, d)) * 0.05,
                      dtype=torch.float32)
    xr = x.clone().requires_grad_()
    y_one, _ = moe_block(xr, router, wg, wu, wd, topk=2, capacity_factor=4.0)
    y_one.sum().backward()
    rules = default_rules(mesh)

    def put(t, axes):
        return distribute_tensor(t, mesh, sharding_for(axes, t.shape, mesh,
                                                       rules)[1])
    with mesh_context(mesh, rules):
        xg = put(x, ("batch", None, None)).requires_grad_()
        ws = [put(router, ("embed_fsdp", None)),
              put(wg, ("expert", "embed_fsdp", None)),
              put(wu, ("expert", "embed_fsdp", None)),
              put(wd, ("expert", None, "embed_fsdp"))]
        y, aux = moe_block_local(xg, *ws, topk=2, capacity_factor=4.0)
        y.sum().backward()
        y, g = y.full_tensor().detach(), xg.grad.full_tensor()
    return {"y": y.numpy(), "y_one": y_one.detach().numpy(),
            "grad": g.numpy(), "grad_one": xr.grad.numpy(),
            "aux": float(aux["moe_aux_loss"].full_tensor())}


def model_case(rank, arch):
    import dataclasses
    from torch.distributed.tensor import DTensor, distribute_tensor
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.partitioning import (default_rules,
                                                 mesh_context, sharding_for)
    from repro_torch.models import (cache_specs, decode_step, forward_train,
                                    init_params, param_specs, prefill)
    mesh = make_mesh((4, 2), ("data", "model"))
    rules = default_rules(mesh)
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    if cfg.family == "moe":  # MQA: one KV head, whole on each device
        cfg = dataclasses.replace(cfg, n_kv_heads=1, capacity_factor=4.0)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(3)
    B, S = 8, 16
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, S)),
                        dtype=torch.int32)
    nxt = [torch.tensor(rng.integers(0, cfg.vocab, (B,)), dtype=torch.int32)
           for _ in range(2)]

    def run(put, cache_put, out):
        logits, cache = prefill(model, cfg, {"tokens": put(toks, 2)},
                                capacity=S + 2)
        cache = {k: cache_put(k, v) for k, v in cache.items()}
        outs = [logits]
        for t, tok in enumerate(nxt):
            pos = torch.full((B,), S + t, dtype=torch.int32)
            logits, cache = decode_step(model, cfg, {"tokens": put(tok, 1)},
                                        cache, put(pos, 1))
            outs.append(logits)
        loss, _ = forward_train(model, cfg, {"tokens": put(toks, 2),
                                             "labels": put(toks, 2)})
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return ([out(t) for t in outs],
                {k: out(v) for k, v in cache.items()}, out(loss),
                [out(g) for g in grads])

    same = lambda t: t.detach()
    one = run(lambda t, n: t, lambda k, v: v, same)

    def put_axes(t, axes):
        pl = sharding_for(axes, t.shape, mesh, rules)[1]
        if isinstance(t, DTensor):  # prefill's cache: lay it out for decode
            return t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl)
    axes = param_specs(cfg)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, attr, torch.nn.Parameter(put_axes(p.data,
                                                           axes[name])))
    caxes = cache_specs(cfg, 2)
    with mesh_context(mesh, rules):
        sharded = run(lambda t, n: put_axes(t, ("batch",) + (None,) * (n - 1)),
                      lambda k, v: put_axes(v, caxes[k]),
                      lambda t: (t.full_tensor() if isinstance(t, DTensor)
                                 else t).detach())
    out = {"placements": " ".join(sorted({str(p.placements)
                                          for p in model.parameters()}))}
    for tag, (logits, cache, loss, grads) in (("one", one),
                                              ("sharded", sharded)):
        for i, l in enumerate(logits):
            out[f"{tag} logits {i}"] = l.numpy()
        for k, v in cache.items():
            out[f"{tag} cache {k}"] = v.float().numpy()
        out[f"{tag} loss"] = loss.numpy()
        for i, g in enumerate(grads):
            out[f"{tag} grad {i}"] = g.numpy()
    return out


def worker(rank, world, port, case, path):
    try:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        name, _, arch = case.partition(":")
        out = moe_case(rank) if name == "moe" else model_case(rank, arch)
        if rank == 0:
            np.savez(path, **out)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    case, path = sys.argv[1], sys.argv[2]
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(worker, args=(8, port, case, path), nprocs=8,
                       start_method="spawn")
    print("WORKERS-OK")
''')


def _run(case, tmp_path):
    script = tmp_path / "workers.py"
    script.write_text(_WORKERS)
    out = tmp_path / f"{case.replace(':', '_')}.npz"
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), case, str(out)],
                       cwd=os.getcwd(), env=env, capture_output=True,
                       text=True, timeout=540)
    assert "WORKERS-OK" in r.stdout and out.exists(), r.stdout + r.stderr
    return dict(np.load(out))


def test_expert_parallel_moe_matches_one_process_and_reference(tmp_path):
    got = _run("moe", tmp_path)
    rng = np.random.default_rng(7)
    d, E, ff = 32, 8, 64
    x = np.asarray(rng.standard_normal((8, 16, d)), np.float32)
    router = jnp.asarray(rng.standard_normal((d, E)) * 0.1, jnp.float32)
    wg = jnp.asarray(rng.standard_normal((E, d, ff)) * 0.05, jnp.float32)
    wu = jnp.asarray(rng.standard_normal((E, d, ff)) * 0.05, jnp.float32)
    wd = jnp.asarray(rng.standard_normal((E, ff, d)) * 0.05, jnp.float32)
    y_ref, aux_ref = jmoe_block(jnp.asarray(x), router, wg, wu, wd, topk=2,
                                capacity_factor=4.0)
    np.testing.assert_allclose(got["y"], got["y_one"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["y"], np.asarray(y_ref), rtol=0,
                               atol=1e-5)
    assert np.isfinite(got["grad"]).all()
    np.testing.assert_allclose(got["grad"], got["grad_one"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["aux"], float(aux_ref["moe_aux_loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-2.7b"])
def test_sharded_model_matches_one_process(arch, tmp_path):
    got = _run(f"model:{arch}", tmp_path)
    assert "Shard(dim=" in str(got["placements"])
    bad = []
    for key in [k for k in got if k.startswith("one ")]:
        want, have = got[key], got["sharded " + key[4:]]
        scale = max(float(np.abs(want).max()), 1.0)
        if not np.allclose(have, want, rtol=0, atol=1e-5 * scale):
            bad.append((key[4:], float(np.abs(have - want).max()), scale))
    assert not bad, bad
