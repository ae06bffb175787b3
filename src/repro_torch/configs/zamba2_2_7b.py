"""zamba2-2.7b [hybrid] — Mamba2 + weight-shared attn blocks.  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000, head_dim=80,
    ssm_state=64, ssm_headdim=64, ssm_groups=1, ssm_chunk=256,
    shared_attn_every=6,
)
