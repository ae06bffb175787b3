"""Block definitions and apply functions for the dense, moe and mamba2 kinds.

Counterpart of the reference's ``models/blocks.py``:

* dense  — pre-norm GQA attention + SwiGLU MLP (optional qk-norm, M-RoPE);
* moe    — pre-norm GQA attention + top-k MoE MLP (``models/moe.py``);
* mamba2 — pre-norm Mamba2 (SSD) mixer.

Hybrid models (Zamba2) put one weight-shared dense block after every
``shared_attn_every`` mamba2 blocks (see ``model.py``); the vlm and audio
families are stacks of dense blocks (M-RoPE, or non-causal attention).
The parameter declarations (``*_param_defs``) keep the reference's shapes
and init kinds; the modules hold them as ``nn.Parameter``s, and the
``apply_*`` functions keep the reference's names and bodies, with each
module's ``forward`` and ``decode`` calling them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.attention import append_kv, decode_gqa_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, rmsnorm,
                                      swiglu)
from repro_torch.models.mamba2 import mamba2_decode, mamba2_mixer
from repro_torch.models.moe import moe_block, moe_block_local
from repro_torch.models.params import ParamDef, ParamModule

__all__ = [
    "CONV_KW", "attn_param_defs", "mlp_param_defs", "moe_param_defs",
    "mamba2_param_defs", "moe_block_defs",
    "DenseBlock", "MoEBlock", "Mamba2Block",
    "apply_attn", "apply_attn_decode", "apply_dense_block",
    "apply_dense_block_decode", "apply_moe_block", "apply_moe_block_decode",
    "apply_mamba2_block", "apply_mamba2_block_decode",
]

CONV_KW = 4  # Mamba2 depthwise conv kernel width


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------


def attn_param_defs(cfg) -> Dict[str, ParamDef]:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "ln": ParamDef((D,), init="ones"),
        "wq": ParamDef((D, H * hd)),
        "wk": ParamDef((D, K * hd)),
        "wv": ParamDef((D, K * hd)),
        "wo": ParamDef((H * hd, D), init_scale=out_scale),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((hd,), init="ones")
        p["k_norm"] = ParamDef((hd,), init="ones")
    return p


def mlp_param_defs(cfg) -> Dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((D,), init="ones"),
        "w_gate": ParamDef((D, F)),
        "w_up": ParamDef((D, F)),
        "w_down": ParamDef((F, D), init_scale=out_scale),
    }


def moe_param_defs(cfg) -> Dict[str, ParamDef]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((D,), init="ones"),
        "router": ParamDef((D, E)),
        "w_gate": ParamDef((E, D, F)),
        "w_up": ParamDef((E, D, F)),
        "w_down": ParamDef((E, F, D), init_scale=out_scale),
    }


def mamba2_param_defs(cfg) -> Dict[str, ParamDef]:
    D, din = cfg.d_model, cfg.d_inner
    H, G, N = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_state
    conv_dim = din + 2 * G * N
    zdim = 2 * din + 2 * G * N + H
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)

    def a_log_init(gen):
        return torch.log(torch.linspace(1.0, 16.0, H))

    def dt_bias_init(gen):
        u = torch.rand((H,), generator=gen, device=gen.device)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))  # inverse softplus

    return {
        "ln": ParamDef((D,), init="ones"),
        "in_proj": ParamDef((D, zdim)),
        "conv_w": ParamDef((conv_dim, CONV_KW), init_scale=0.1),
        "conv_b": ParamDef((conv_dim,), init="zeros"),
        "dt_bias": ParamDef((H,), custom_init=dt_bias_init),
        "A_log": ParamDef((H,), custom_init=a_log_init),
        "D": ParamDef((H,), init="ones"),
        "norm_scale": ParamDef((din,), init="ones"),
        "out_proj": ParamDef((din, D), init_scale=out_scale),
    }


def moe_block_defs(cfg) -> Dict[str, Dict[str, ParamDef]]:
    return {"attn": attn_param_defs(cfg), "moe": moe_param_defs(cfg)}


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def _project_qkv(p, cfg, h):
    B, S, _ = h.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dtype = h.dtype
    q = (h @ p.wq.to(dtype)).reshape(B, S, H, hd)
    k = (h @ p.wk.to(dtype)).reshape(B, S, K, hd)
    v = (h @ p.wv.to(dtype)).reshape(B, S, K, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _rope(cfg, x, positions):
    if cfg.mrope_sections is not None:
        return apply_mrope(x, positions, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def apply_attn(p, cfg, h: torch.Tensor, positions: torch.Tensor, *,
               window: Optional[int] = None, return_kv: bool = False):
    """Attention sublayer (pre-norm, residual) for prefill.

    With ``return_kv`` it also returns ``(k, v)`` for the KV cache.
    """
    resid = h
    h = rmsnorm(h, p.ln, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    out = attn_ops.flash_attention(q, k, v, causal=cfg.causal, window=window)
    B, S = out.shape[:2]
    out = out.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo.to(h.dtype)
    return resid + out, ((k, v) if return_kv else None)


def apply_attn_decode(p, cfg, h: torch.Tensor, pos: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      kv_positions: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Decode attention sublayer; writes this token's K/V into the cache in
    place.  ``kv_positions`` already holds the current token (updated once
    per step, before the layers)."""
    resid = h
    h = rmsnorm(h, p.ln, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, h)
    positions = pos[:, None]
    if cfg.mrope_sections is not None:  # one id on all three axes
        positions = pos[:, None, None].expand(pos.shape[0], 1, 3)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    append_kv(cache_k, cache_v, k, v, pos)
    out = decode_gqa_attention(q, cache_k, cache_v, kv_positions, pos,
                               window=window)
    out = out.reshape(h.shape[0], 1, cfg.n_heads * cfg.hd)
    return resid + out @ p.wo.to(h.dtype)


def _mlp(p, cfg, h):
    return h + swiglu(rmsnorm(h, p.ln, cfg.norm_eps), p.w_gate, p.w_up,
                      p.w_down)


def apply_dense_block(p, cfg, h, positions, window=None, return_kv=False):
    h, kv = apply_attn(p.attn, cfg, h, positions, window=window,
                       return_kv=return_kv)
    return _mlp(p.mlp, cfg, h), kv


def apply_dense_block_decode(p, cfg, h, pos, cache_k, cache_v, kv_positions,
                             window=None):
    h = apply_attn_decode(p.attn, cfg, h, pos, cache_k, cache_v,
                          kv_positions, window=window)
    return _mlp(p.mlp, cfg, h)


def _moe(p, cfg, h):
    """The MoE sublayer (pre-norm, residual): ``(h, aux)``."""
    fn = moe_block_local if cfg.moe_local_dispatch else moe_block
    out, aux = fn(rmsnorm(h, p.ln, cfg.norm_eps), p.router, p.w_gate,
                  p.w_up, p.w_down, topk=cfg.topk,
                  capacity_factor=cfg.capacity_factor)
    return h + out, aux


def apply_moe_block(p, cfg, h, positions, window=None, return_kv=False):
    """Returns ``(h, (k, v) or None, aux)``."""
    h, kv = apply_attn(p.attn, cfg, h, positions, window=window,
                       return_kv=return_kv)
    h, aux = _moe(p.moe, cfg, h)
    return h, kv, aux


def apply_moe_block_decode(p, cfg, h, pos, cache_k, cache_v, kv_positions,
                           window=None):
    h = apply_attn_decode(p.attn, cfg, h, pos, cache_k, cache_v,
                          kv_positions, window=window)
    return _moe(p.moe, cfg, h)[0]


def apply_mamba2_block(p, cfg, h):
    """Prefill Mamba2 block.  Returns ``(h, final_ssm_state, conv_tail)``."""
    out, final_state, conv_tail = mamba2_mixer(
        p.mamba, cfg, rmsnorm(h, p.mamba.ln, cfg.norm_eps))
    return h + out, final_state, conv_tail


def apply_mamba2_block_decode(p, cfg, h, conv_state, ssm_state):
    """Returns ``(h, new_conv_state, new_ssm_state)``."""
    out, new_conv, new_ssm = mamba2_decode(
        p.mamba, cfg, rmsnorm(h, p.mamba.ln, cfg.norm_eps), conv_state,
        ssm_state)
    return h + out, new_conv, new_ssm


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    """Pre-norm GQA attention + SwiGLU MLP (also Zamba2's shared block)."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        self.attn = ParamModule(attn_param_defs(cfg), generator, device)
        self.mlp = ParamModule(mlp_param_defs(cfg), generator, device)

    def forward(self, h, positions, window=None, return_kv=False):
        return apply_dense_block(self, self.cfg, h, positions, window,
                                 return_kv)

    def decode(self, h, pos, cache_k, cache_v, kv_positions, window=None):
        return apply_dense_block_decode(self, self.cfg, h, pos, cache_k,
                                        cache_v, kv_positions, window)


class MoEBlock(nn.Module):
    """Pre-norm GQA attention + top-k MoE MLP."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        for name, defs in moe_block_defs(cfg).items():
            setattr(self, name, ParamModule(defs, generator, device))

    def forward(self, h, positions, window=None, return_kv=False):
        return apply_moe_block(self, self.cfg, h, positions, window,
                               return_kv)

    def decode(self, h, pos, cache_k, cache_v, kv_positions, window=None):
        return apply_moe_block_decode(self, self.cfg, h, pos, cache_k,
                                      cache_v, kv_positions, window)


class Mamba2Block(nn.Module):
    """Pre-norm Mamba2 mixer."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        self.mamba = ParamModule(mamba2_param_defs(cfg), generator, device)

    def forward(self, h):
        return apply_mamba2_block(self, self.cfg, h)

    def decode(self, h, conv_state, ssm_state):
        return apply_mamba2_block_decode(self, self.cfg, h, conv_state,
                                         ssm_state)
