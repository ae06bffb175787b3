"""AdamW with decoupled weight decay and global-norm clipping.

Counterpart of the reference's ``optim/adamw.py``, with its rules: the
global norm of all gradients in float32, ``b2 = 0.95``, ``eps`` outside
``sqrt(v / c2)``, decay only of tensors with ``ndim > 1`` (norm scales and
biases are 1-d) and ``p - lr * (step + wd * p)`` in that rounding order,
on float32 masters.  The reference applies the ``ndim`` rule to its
stacked tensors, where every per-layer block parameter has a layer axis
and so decays; the port holds one tensor per layer, and its callers pass
that choice as ``decay`` (:func:`repro_torch.models.decayed`).
``torch.optim.AdamW`` differs on two of the rules (it decays every tensor
unless grouped, and applies ``p * (1 - lr * wd)`` before the step), so it
is not used.  The reference's pure functions return new trees (donated buffers
under ``jit``); here :func:`adamw_update` updates the parameters and the
moments in place, tensor by tensor, so the temporaries are those of one
tensor at a time.

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "count": int32
0-d tensor}``, keyed like the parameters it was made for.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["adamw_init", "adamw_update", "cosine_schedule"]


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Zero float32 moments beside ``params`` (``{name: tensor}``, laid
    out as each parameter: a DTensor's moments are DTensors) and a zero
    int32 step count, on the parameters' device."""
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
              for k, p in params.items()},
        "v": {k: torch.zeros_like(p, dtype=torch.float32,
                                  memory_format=torch.contiguous_format)
              for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], opt_state: Dict,
                 params: Mapping[str, torch.Tensor], *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0,
                 decay: Optional[Mapping[str, bool]] = None) -> Dict:
    """One AdamW step on ``params`` and ``opt_state`` in place, from
    ``grads`` (same keys; a missing or None gradient counts as zero).
    ``decay`` says which tensors take weight decay (default: ``ndim > 1``).
    Returns ``{"grad_norm", "clip_scale"}`` as 0-d float32 tensors."""
    gs = {k: (grads.get(k) if grads.get(k) is not None
              else torch.zeros_like(p)) for k, p in params.items()}
    sq = torch.stack([torch.sum(torch.square(g.float()))
                      for g in gs.values()]).sum()
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    count = opt_state["count"] + 1
    opt_state["count"] = count
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for k, p in params.items():
        g = gs[k].float() * scale
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
        step = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
        decays = p.ndim > 1 if decay is None else decay[k]
        wd = weight_decay if decays else 0.0
        step.add_(p * wd)
        p.sub_(step.mul_(lr))
    return {"grad_norm": gnorm, "clip_scale": scale}


def cosine_schedule(*, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """``lr(step)``: linear warm-up, then cosine decay to ``min_ratio`` of
    the peak, computed in float32 as the reference; returns a float."""
    f = np.float32

    def lr(step) -> float:
        s = f(int(step))
        warm = s / f(max(warmup_steps, 1))
        t = np.clip((s - f(warmup_steps)) / f(max(total_steps - warmup_steps,
                                                     1)), f(0), f(1))
        cos = f(min_ratio) + f(1 - min_ratio) * f(0.5) * (
            f(1) + np.cos(f(math.pi) * t, dtype=np.float32))
        return float(f(peak_lr) * (warm if s < warmup_steps else cos))
    return lr
