"""Train and serve step functions, counterparts of the reference's
``runtime/steps.py``.

PyTorch runs eagerly, so a step is the model call with the config bound.
:func:`make_train_step`'s step updates the parameters and the AdamW state
in place, PyTorch's counterpart of the reference's donated buffers, and
returns the metrics; given DTensor parameters (a mesh) it first lays each
gradient out as its parameter (the data-parallel reduction, the
reference's ``out_shardings``).  :func:`make_encode_step` is an
encoder-only model's (hubert's) "prefill": the full forward to every
frame's logits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import decayed, decode_step, forward_train, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (_default_positions, _embed_inputs,
                                      _forward_seq, _head_logits)
from repro_torch.optim import adamw_update, cosine_schedule

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "make_encode_step", "step_fn_for"]


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup_steps: int = 100, total_steps: int = 10_000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0):
    """``train_step(model, opt_state, batch, step) -> metrics``: loss and
    gradients of :func:`forward_train`, then one AdamW step at the cosine
    schedule's ``lr(step)``.  Metrics: ``loss``, ``ce_loss``, ``lr``,
    ``grad_norm`` and ``clip_scale`` (0-d tensors, ``lr`` a float), and an
    MoE model's aux terms."""
    lr_fn = cosine_schedule(peak_lr=peak_lr, warmup_steps=warmup_steps,
                            total_steps=total_steps)

    def train_step(model, opt_state, batch, step):
        params = dict(model.named_parameters())
        decay = decayed(cfg, params)
        loss, metrics = forward_train(model, cfg, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(g, DTensor) else g
                 for g, p in zip(grads, params.values())]
        lr = lr_fn(step)
        stats = adamw_update(dict(zip(params, grads)), opt_state, params,
                             lr=lr, weight_decay=weight_decay,
                             clip_norm=clip_norm, decay=decay)
        return dict({k: v.detach() for k, v in metrics.items()}, lr=lr,
                    **stats)

    return train_step


def make_prefill_step(cfg: ModelConfig, capacity: Optional[int] = None):
    def prefill_step(model, batch):
        return prefill(model, cfg, batch, capacity=capacity)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(model, batch, cache, pos):
        return decode_step(model, cfg, batch, cache, pos)
    return serve_step


def make_encode_step(cfg: ModelConfig):
    """``encode_step(model, batch) -> logits (B, S, V)`` float32: every
    position's logits of ``embeds`` (or ``tokens``) through the whole model,
    without autograd or a cache."""
    @torch.no_grad()
    def encode_step(model, batch):
        h = _embed_inputs(model, cfg, batch)
        positions = batch.get("positions")
        if positions is None:
            positions = _default_positions(cfg, h.shape[0], h.shape[1],
                                           h.device)
        h, _, _ = _forward_seq(model, cfg, h, positions, collect_cache=False)
        return _head_logits(model, cfg, h)
    return encode_step


def step_fn_for(cfg: ModelConfig, kind: str) -> Callable:
    if kind == "train":
        return make_train_step(cfg)
    if kind == "prefill":
        return make_prefill_step(cfg)
    if kind == "encode":
        return make_encode_step(cfg)
    if kind == "decode":
        return make_decode_step(cfg)
    raise ValueError(kind)
