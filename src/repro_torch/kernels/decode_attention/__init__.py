"""Single-token GQA attention over a KV cache: the decode kernel of every
attention block."""

from repro_torch.kernels.decode_attention.ops import LAUNCHES, decode_attention

__all__ = ["LAUNCHES", "decode_attention"]
