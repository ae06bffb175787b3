"""Model zoo of the port: the dense, moe, vlm (M-RoPE), audio
(encoder-only), ssm (Mamba2) and hybrid (Zamba2) families, served through
``prefill`` / ``decode_step`` (audio through
``runtime.make_encode_step``) and trained through ``forward_train``.

``load_jax_params`` carries the reference package's weights (as numpy
arrays) into the port's :class:`Model`, so the two can be compared;
``export_tree`` / ``import_tree`` move named tensors to and from the
reference's tree layout (its checkpoints').
"""

from repro_torch.models.config import SMOKE_OVERRIDES, ModelConfig
from repro_torch.models.model import (
    Model,
    cache_shapes,
    decayed,
    decode_step,
    export_tree,
    forward_train,
    import_tree,
    init_cache,
    init_params,
    load_jax_params,
    prefill,
    tree_shapes,
)

__all__ = [
    "ModelConfig", "SMOKE_OVERRIDES", "Model", "cache_shapes",
    "decayed", "decode_step", "export_tree", "forward_train", "import_tree",
    "init_cache", "init_params", "load_jax_params", "prefill",
    "tree_shapes",
]
