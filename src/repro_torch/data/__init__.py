"""Data pipeline substrate."""

from repro_torch.data.pipeline import SyntheticLMDataset, host_batch

__all__ = ["SyntheticLMDataset", "host_batch"]
