"""The training loop: real steps on one card, fault-tolerant.

Counterpart of the reference's ``launch/train.py``.  Runs any ``--arch``
(smoke-reduced by default; ``--full`` for the published widths; the vlm
and audio families take ``host_batch``'s stubbed-frontend ``embeds``, vlm
its 3-axis ``positions``) through the production loop: deterministic data
per step, async atomic checkpoints in the reference's layout (a checkpoint
of either package resumes in the other), ``--resume``, simulated
preemption (``--kill-at-step``), the straggler count and the KS+ memory
monitor (``sched.monitor.MemoryMonitor``).  As in the reference,
``remat`` is "none".  The reference's local mesh, partitioning rules and
sharded parameters (``make_local_mesh``, ``default_rules``,
``tree_shardings``) are not wired in yet: the loop trains on one card
(the pieces exist in ``launch.mesh`` / ``launch.partitioning``; ROADMAP
lists the wiring with the last module slice).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-2.7b --full --seq 2048 --batch 1

Without ``--device`` the card is used (and its absence raises).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data import host_batch
from repro_torch.device import resolve_device
from repro_torch.models import export_tree, import_tree, init_params, \
    tree_shapes
from repro_torch.optim import adamw_init
from repro_torch.runtime import make_train_step
from repro_torch.sched.monitor import MemoryMonitor

__all__ = ["train", "train_state", "load_train_state"]


def train_state(cfg, params, opt, shapes: bool = False):
    """``{"params": ..., "opt": {"m", "v", "count"}}`` in the reference's
    layout: numpy arrays on the host, or with ``shapes`` only their shapes
    (a restore template)."""
    tree = tree_shapes if shapes else export_tree
    count = () if shapes else opt["count"].cpu().numpy()
    return {"params": tree(cfg, params),
            "opt": {"m": tree(cfg, opt["m"]), "v": tree(cfg, opt["v"]),
                    "count": count}}


def load_train_state(cfg, state, params, opt) -> None:
    """Copy a :func:`train_state` tree into the parameters and AdamW state
    in place."""
    import_tree(cfg, state["params"], params)
    import_tree(cfg, state["opt"]["m"], opt["m"])
    import_tree(cfg, state["opt"]["v"], opt["v"])
    opt["count"].fill_(int(state["opt"]["count"]))


def train(arch: str, *, steps: int = 50, seq: int = 128, batch: int = 8,
          smoke: bool = True, ckpt_dir: str | None = None,
          resume: bool = False, kill_at_step: int = -1,
          ckpt_every: int = 20, peak_lr: float = 3e-3,
          log_every: int = 10, seed: int = 0, monitor: bool = True,
          device=None):
    """Train ``arch`` for ``steps`` steps; returns a dict with ``status``
    and, once done, the reference's keys plus ``losses`` and ``step_s``
    (every step's loss and seconds)."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    cfg = dataclasses.replace(cfg, remat="none")

    mon = MemoryMonitor(job_type=f"train:{arch}",
                        input_size=float(batch * seq)) if monitor else None

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    params = dict(model.named_parameters())
    opt = adamw_init(params)

    start_step = 0
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if mgr and resume and mgr.latest_step() is not None:
        start_step = mgr.latest_step()
        state = mgr.restore(start_step,
                            train_state(cfg, params, opt, shapes=True))
        load_train_state(cfg, state, params, opt)
        print(f"[train] resumed from step {start_step}")

    step_fn = make_train_step(
        cfg, peak_lr=peak_lr, total_steps=max(steps, 2),
        warmup_steps=max(min(100, steps // 5), 1))
    losses = []
    t0 = time.time()
    slow_steps = 0
    step_times = []
    for step in range(start_step, steps):
        if step == kill_at_step:
            print(f"[train] simulated preemption at step {step}")
            if mgr:
                mgr.wait()
            return dict(status="killed", step=step, losses=losses)
        bt = host_batch(cfg, seq, batch, step, seed=seed)
        bt = {k: torch.as_tensor(v, device=dev) for k, v in bt.items()}
        ts = time.time()
        metrics = step_fn(model, opt, bt, step)
        loss = float(metrics["loss"])  # waits for the step
        losses.append(loss)
        step_times.append(time.time() - ts)
        # straggler hook: flag steps >3x the trailing median
        if len(step_times) > 5 and step_times[-1] > 3 * float(
                np.median(step_times[-20:])):
            slow_steps += 1
        if mon:
            mon.sample()
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save_async(step + 1, train_state(cfg, params, opt),
                           meta=dict(loss=loss))
        if (step + 1) % log_every == 0 or step == start_step:
            print(f"[train] step {step + 1}/{steps} loss {loss:.4f} "
                  f"({step_times[-1]*1e3:.0f} ms)")
    if mgr:
        if steps % ckpt_every == 0:
            mgr.wait()  # final step already checkpointed asynchronously
        else:
            mgr.save(steps, train_state(cfg, params, opt),
                     meta=dict(loss=losses[-1] if losses else None))
    out = dict(status="done", steps=steps, final_loss=losses[-1],
               first_loss=losses[0], elapsed_s=time.time() - t0,
               slow_steps=slow_steps, losses=losses, step_s=step_times)
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
    out = train(args.arch, steps=args.steps, seq=args.seq, batch=args.batch,
                smoke=not args.full, ckpt_dir=args.checkpoint_dir,
                resume=args.resume, kill_at_step=args.kill_at_step,
                seed=args.seed, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "rss_trace_gb"},
                     indent=1))


if __name__ == "__main__":
    main()
