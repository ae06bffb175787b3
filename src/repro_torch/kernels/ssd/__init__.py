"""Mamba2 SSD scan: the prefill and training kernel of every Mamba2 block,
and its backward."""

from repro_torch.kernels.ssd.ops import LAUNCHES, ssd, ssd_bwd

__all__ = ["LAUNCHES", "ssd", "ssd_bwd"]
