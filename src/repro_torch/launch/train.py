"""The training loop: real steps on the local mesh, fault-tolerant.

Counterpart of the reference's ``launch/train.py``.  Runs any ``--arch``
(smoke-reduced by default; ``--full`` for the published widths; the vlm
and audio families take ``host_batch``'s stubbed-frontend ``embeds``, vlm
its 3-axis ``positions``) through the production loop: the sharded step,
deterministic data per step, async atomic checkpoints in the reference's
layout (a checkpoint of either package resumes in the other), ``--resume``,
simulated preemption (``--kill-at-step``), the straggler count and the KS+
memory monitor (``sched.monitor.MemoryMonitor``).  As in the reference,
``remat`` is "none".

The mesh is the reference's local mesh, ``(world, 1)`` ("data", "model")
over the processes of the process group (``launch.mesh.make_local_mesh``)
with ``default_rules``: "batch" and "embed_fsdp" map to ``data``, so a
world of ``n`` processes trains data parallel with FSDP parameters, and
one process trains on a ``(1, 1)`` mesh.  Every parameter is a DTensor
placed by ``tree_shardings`` (drawn whole from the seeded generator on
every rank first, so that each rank's shards are one process's draw), the
AdamW moments follow it, and each step's batch is laid out on "batch".
Without a process group ``train`` starts a one-rank group over the device
(``device.process_world``) and destroys it on every return; a caller's
group is left as it is.  Every rank gathers a checkpoint's whole tensors
and only rank 0 writes them; the other ranks meet it where the run ends
or is killed, once its last write is on disk.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --full --seq 2048 --batch 1
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen3-1.7b

Without ``--device`` the card is used (and its absence raises); under
``torchrun`` each process takes the card of its ``LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data import host_batch
from repro_torch.device import group_backend, process_world, resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.partitioning import (default_rules, mesh_context,
                                             sharding_for, tree_shardings)
from repro_torch.models import export_tree, import_tree, init_params, \
    param_shapes, param_specs, tree_shapes
from repro_torch.optim import adamw_init
from repro_torch.runtime import make_train_step
from repro_torch.sched.monitor import MemoryMonitor

__all__ = ["train", "train_state", "load_train_state", "place_params"]


def train_state(cfg, params, opt, shapes: bool = False):
    """``{"params": ..., "opt": {"m", "v", "count"}}`` in the reference's
    layout: numpy arrays on the host (a DTensor gathered whole: every rank
    calls this), or with ``shapes`` only their shapes (a restore
    template)."""
    tree = tree_shapes if shapes else export_tree
    count = () if shapes else opt["count"].cpu().numpy()
    return {"params": tree(cfg, params),
            "opt": {"m": tree(cfg, opt["m"]), "v": tree(cfg, opt["v"]),
                    "count": count}}


def load_train_state(cfg, state, params, opt) -> None:
    """Copy a :func:`train_state` tree into the parameters and AdamW state
    in place (each DTensor takes its own shards)."""
    import_tree(cfg, state["params"], params)
    import_tree(cfg, state["opt"]["m"], opt["m"])
    import_tree(cfg, state["opt"]["v"], opt["v"])
    opt["count"].fill_(int(state["opt"]["count"]))


def place_params(model, cfg, mesh, rules) -> None:
    """Swap every parameter of ``model`` for a DTensor parameter placed by
    ``tree_shardings`` of the reference's axes, under the same name; each
    rank keeps its own shards of the whole tensor it holds."""
    shardings = tree_shardings(param_specs(cfg), param_shapes(cfg), mesh,
                               rules)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            mod = model.get_submodule(mod_name)
            m, placements = shardings[name]
            setattr(mod, attr, nn.Parameter(distribute_tensor(
                p.data, m, placements, src_data_rank=None)))


def _place_batch(bt, dev, mesh, rules):
    """Each batch array on ``dev``, laid out on "batch" (dimension 0)."""
    out = {}
    for k, v in bt.items():
        t = torch.as_tensor(v, device=dev)
        _, placements = sharding_for(("batch",) + (None,) * (t.dim() - 1),
                                     t.shape, mesh, rules)
        out[k] = distribute_tensor(t, mesh, placements, src_data_rank=None)
    return out


def _host_scalar(t) -> float:
    """A 0-d tensor's value on the host (a DTensor's whole value)."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return float(t)


def _meet(dev) -> None:
    """All ranks of a world of more than one wait here."""
    if dist.get_world_size() > 1:
        dist.barrier(device_ids=[dev.index] if dev.type == "cuda" else None)


def train(arch: str, *, steps: int = 50, seq: int = 128, batch: int = 8,
          smoke: bool = True, ckpt_dir: str | None = None,
          resume: bool = False, kill_at_step: int = -1,
          ckpt_every: int = 20, peak_lr: float = 3e-3,
          log_every: int = 10, seed: int = 0, monitor: bool = True,
          device=None):
    """Train ``arch`` for ``steps`` steps on the local mesh; returns a
    dict with ``status`` and, once done, the reference's keys plus
    ``losses`` and ``step_s`` (every step's loss and seconds)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, remat="none")

    mon = MemoryMonitor(job_type=f"train:{arch}",
                        input_size=float(batch * seq)) if monitor else None

    with process_world(dev):
        mesh = make_local_mesh(dev.type)
        rules = default_rules(mesh)
        lead = dist.get_rank() == 0
        say = print if lead else (lambda *a, **k: None)
        with mesh_context(mesh, rules):
            model = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed),
                device=dev)
            place_params(model, cfg, mesh, rules)
            params = dict(model.named_parameters())
            opt = adamw_init(params)

            start_step = 0
            mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
            if mgr and resume and mgr.latest_step() is not None:
                start_step = mgr.latest_step()
                state = mgr.restore(start_step,
                                    train_state(cfg, params, opt,
                                                shapes=True))
                load_train_state(cfg, state, params, opt)
                say(f"[train] resumed from step {start_step}")

            step_fn = make_train_step(
                cfg, peak_lr=peak_lr, total_steps=max(steps, 2),
                warmup_steps=max(min(100, steps // 5), 1))
            losses = []
            t0 = time.time()
            slow_steps = 0
            step_times = []
            for step in range(start_step, steps):
                if step == kill_at_step:
                    say(f"[train] simulated preemption at step {step}")
                    if mgr:
                        mgr.wait()
                        _meet(dev)
                    return dict(status="killed", step=step, losses=losses)
                bt = _place_batch(host_batch(cfg, seq, batch, step,
                                             seed=seed), dev, mesh, rules)
                ts = time.time()
                metrics = step_fn(model, opt, bt, step)
                loss = _host_scalar(metrics["loss"])  # waits for the step
                losses.append(loss)
                step_times.append(time.time() - ts)
                # straggler hook: flag steps >3x the trailing median
                if len(step_times) > 5 and step_times[-1] > 3 * float(
                        np.median(step_times[-20:])):
                    slow_steps += 1
                if mon:
                    mon.sample()
                if mgr and (step + 1) % ckpt_every == 0:
                    state = train_state(cfg, params, opt)
                    if lead:
                        mgr.save_async(step + 1, state,
                                       meta=dict(loss=loss))
                if (step + 1) % log_every == 0 or step == start_step:
                    say(f"[train] step {step + 1}/{steps} loss {loss:.4f} "
                        f"({step_times[-1]*1e3:.0f} ms)")
            if mgr:
                if steps % ckpt_every == 0:
                    mgr.wait()  # final step already checkpointed async
                else:
                    state = train_state(cfg, params, opt)
                    if lead:
                        mgr.save(steps, state, meta=dict(
                            loss=losses[-1] if losses else None))
                _meet(dev)
            out = dict(status="done", steps=steps, final_loss=losses[-1],
                       first_loss=losses[0], elapsed_s=time.time() - t0,
                       slow_steps=slow_steps, losses=losses,
                       step_s=step_times)
            if mon:
                mon.sample(force=True)
                out["rss_trace_gb"] = mon.trace().tolist()
            return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="qwen3-1.7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--kill-at-step", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:  # torchrun: one process per card (or CPU rank)
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group(group_backend(dev))
    try:
        out = train(args.arch, steps=args.steps, seq=args.seq,
                    batch=args.batch, smoke=not args.full,
                    ckpt_dir=args.checkpoint_dir, resume=args.resume,
                    kill_at_step=args.kill_at_step, seed=args.seed,
                    device=args.device)
    finally:
        if world > 1:
            dist.destroy_process_group()
    if int(os.environ.get("RANK", "0")) == 0:
        print(json.dumps({k: v for k, v in out.items()
                          if k != "rss_trace_gb"}, indent=1))


if __name__ == "__main__":
    main()
