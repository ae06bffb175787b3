"""KS+ wastage kernels: the fleet engine's per-attempt OOM probe."""

from repro_torch.kernels.wastage.ops import LAUNCHES, oom_probe, wastage_eval

__all__ = ["LAUNCHES", "oom_probe", "wastage_eval"]
