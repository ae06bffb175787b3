"""The Mamba2 prefill mixer's elementwise work around the SSD scan: the
conv, SiLU, softplus and scan inputs (``mix_in``), and the gate and
RMSNorm after it (``mix_out``), routed by ``mixer``."""

from repro_torch.kernels.mamba2_mix.ops import LAUNCHES, mix_in, mix_out, mixer

__all__ = ["LAUNCHES", "mix_in", "mix_out", "mixer"]
