"""Serving step construction."""

from repro_torch.runtime.steps import make_decode_step, make_prefill_step

__all__ = ["make_prefill_step", "make_decode_step"]
