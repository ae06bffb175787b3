"""Optimizer substrate: AdamW and its learning-rate schedule."""

from repro_torch.optim.adamw import adamw_init, adamw_update, cosine_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule"]
