"""Mamba2 SSD scan: the prefill kernel of every Mamba2 block."""

from repro_torch.kernels.ssd.ops import LAUNCHES, ssd

__all__ = ["LAUNCHES", "ssd"]
