"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_groups=1, ssm_chunk=256,
)
