"""GQA attention forward: the prefill kernel of every attention block."""

from repro_torch.kernels.flash_attention.ops import LAUNCHES, flash_attention

__all__ = ["LAUNCHES", "flash_attention"]
