"""zamba2-2.7b-zyphra [hybrid] — Zamba2-2.7B in Zyphra's own form: two
alternating shared blocks over the stream and the embeddings side by side
(hd 160), a LoRA adapter and a linear a use.  [arXiv:2411.15242;
huggingface.co/Zyphra/Zamba2-2.7B config.json; transformers' Zamba2Config
defaults for the layer ids]"""
from repro_torch.models.config import Zamba2Config

CONFIG = Zamba2Config(
    name="zamba2-2.7b-zyphra", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=160, rope_theta=1e4,
    ssm_state=64, ssm_headdim=64, ssm_groups=1, ssm_chunk=256,
    hybrid_layer_ids=(6, 12, 18, 24, 30, 36, 42, 47, 51),
    num_mem_blocks=2, adapter_rank=128,
)
