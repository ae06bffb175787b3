"""Serving step functions, counterparts of the reference's
``runtime/steps.py::make_prefill_step`` / ``make_decode_step``.

PyTorch runs eagerly, so a step is the model call with the config bound;
the train and encode steps wait for the training slice (ROADMAP A11).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig, capacity: Optional[int] = None):
    def prefill_step(model, batch):
        return prefill(model, cfg, batch, capacity=capacity)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(model, batch, cache, pos):
        return decode_step(model, cfg, batch, cache, pos)
    return serve_step
