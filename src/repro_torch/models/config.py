"""Unified model configuration covering all assigned architecture families.

One :class:`ModelConfig` drives the whole zoo: dense GQA transformers
(optionally qk-norm / M-RoPE / encoder-only), MoE transformers, Mamba2 (SSD)
stacks, and Zamba2-style hybrids: scanned Mamba2 blocks + one weight-shared
attention block applied periodically (the reference's form), or Zamba2's
own (:class:`Zamba2Config`: alternating shared blocks over the stream
concatenated with the embeddings, a LoRA adapter and a linear map per
use, feeding the next Mamba2 layer's input).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "Zamba2Config", "SMOKE_OVERRIDES"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                     # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads

    # attention variants
    qk_norm: bool = False
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    causal: bool = True              # False for encoder-only (hubert)
    sliding_window: Optional[int] = None  # used by hybrid long-context cells

    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25
    moe_local_dispatch: bool = False  # beyond-paper: shard-local dispatch

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssm_expand: int = 2

    # hybrid (Zamba2): apply the weight-shared attention block after every
    # `shared_attn_every`-th scanned Mamba2 block.
    shared_attn_every: int = 0

    # numerics / execution
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # compute dtype
    param_dtype: str = "float32"     # master weights
    remat: str = "full"              # none | full
    scan_layers: bool = True         # False: unroll (exact HLO cost analysis)
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    attn_impl: str = "xla"           # xla (chunked online-softmax) | pallas
    fused_decode_gqa: bool = False   # beyond-paper: fused q@K/softmax/@V layout
    logits_chunk: int = 0            # beyond-paper: chunked LM head + CE (0 = off)
    seq_parallel: bool = False       # beyond-paper: shard saved activations
                                     # (scan carries) over the model axis

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def _mamba_params(self) -> int:
        """One Mamba2 layer: in_proj, out_proj, conv, dt/A/D, norms."""
        D, din, N, G, H = (self.d_model, self.d_inner, self.ssm_state,
                           self.ssm_groups, self.ssm_heads)
        per = D * (2 * din + 2 * G * N + H) + din * D  # in_proj + out_proj
        return per + (din + 2 * G * N) * 4 + 2 * H + 2 * D + din

    def params_count(self) -> int:
        """Approximate parameter count (used for 6·N·D roofline accounting)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        emb = V * D * 2  # embed + untied head
        if self.family == "ssm":
            return emb + L * self._mamba_params()
        att = D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * D
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * F + D * self.n_experts  # experts + router
        else:
            mlp = 3 * D * F
        per = att + mlp + 2 * D
        total = emb + L * per
        if self.family == "hybrid":
            total = emb + L * self._mamba_params() \
                + (att + 3 * D * F + 2 * D)  # one shared blk
        return total

    def active_params_count(self) -> int:
        """Active parameters per token (MoE counts only routed experts)."""
        if self.family != "moe":
            return self.params_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        att = D * self.n_heads * self.hd + 2 * D * self.n_kv_heads * self.hd \
            + self.n_heads * self.hd * D
        mlp_active = self.topk * 3 * D * F + D * self.n_experts
        return self.vocab * D * 2 + L * (att + mlp_active + 2 * D)


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """Zamba2's own form of the hybrid (models/model.py; Zamba,
    arXiv:2405.16712, eq. 6), with ``shared_attn_every`` 0.  Before Mamba2
    layer ``hybrid_layer_ids[u]`` shared block ``u % num_mem_blocks``
    reads the stream concatenated with the embeddings (the attention's
    input is ``2 * d_model`` wide, its softmax scale ``(hd / 2) ** -0.5``,
    no RoPE), its gated-GELU MLP adds use u's rank-``adapter_rank`` adapter
    to its gate and up products, and use u's own ``d_model x d_model``
    matrix maps its output into that Mamba2 layer's input only."""

    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 2
    adapter_rank: int = 128

    def __post_init__(self):
        # a JSON list: keep it hashable
        object.__setattr__(self, "hybrid_layer_ids",
                           tuple(self.hybrid_layer_ids))

    @property
    def attn_in(self) -> int:
        """Width of the shared attention's input: the stream and the
        embeddings side by side."""
        return 2 * self.d_model

    @property
    def attn_scale(self) -> float:
        """The shared attention's softmax scale, as ``transformers``'
        ``modeling_zamba2.py``: the concatenation doubles the width."""
        return (self.hd / 2) ** -0.5

    def _shared(self):
        """Parameters ``(of one shared block, of one use's adapter and
        linear)``."""
        D, F, Din = self.d_model, self.d_ff, self.attn_in
        H, K, hd = self.n_heads, self.n_kv_heads, self.hd
        att = Din * (H + 2 * K) * hd + H * hd * D + Din
        use = D * self.adapter_rank + self.adapter_rank * 2 * F + D * D
        return att + 3 * D * F + D, use

    def params_count(self) -> int:
        block, use = self._shared()
        return self.vocab * self.d_model * 2 \
            + self.n_layers * self._mamba_params() \
            + self.num_mem_blocks * block + len(self.hybrid_layer_ids) * use

    def active_params_count(self) -> int:
        """Each use of a shared block counts, with its adapter and linear."""
        block, use = self._shared()
        return self.vocab * self.d_model * 2 \
            + self.n_layers * self._mamba_params() \
            + len(self.hybrid_layer_ids) * (block + use)


# Reduced-config overrides for CPU smoke tests: same family/topology, tiny.
SMOKE_OVERRIDES = dict(
    n_layers=2,
    d_model=64,
    d_ff=128,
    vocab=256,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    n_experts=4,
    topk=2,
    shared_attn_every=2,
    sliding_window=None,
    attn_chunk_q=32,
    attn_chunk_kv=32,
    remat="none",
)
