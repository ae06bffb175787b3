"""Model zoo of the port: the dense, ssm (Mamba2) and hybrid (Zamba2)
families, served through ``prefill`` / ``decode_step``.

``load_jax_params`` carries the reference package's weights (as numpy
arrays) into the port's :class:`Model`, so the two can be compared.
"""

from repro_torch.models.config import SMOKE_OVERRIDES, ModelConfig
from repro_torch.models.model import (
    Model,
    cache_shapes,
    decode_step,
    init_cache,
    init_params,
    load_jax_params,
    prefill,
)

__all__ = [
    "ModelConfig", "SMOKE_OVERRIDES", "Model", "cache_shapes",
    "decode_step", "init_cache", "init_params", "load_jax_params",
    "prefill",
]
