"""GQA attention: the prefill and training kernel of every attention block,
and its backward."""

from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES,
    flash_attention,
    flash_attention_bwd,
)

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_bwd"]
