"""Block definitions and apply functions for the dense, moe and mamba2 kinds.

Counterpart of the reference's ``models/blocks.py``:

* dense  — pre-norm GQA attention + SwiGLU MLP (optional qk-norm, M-RoPE);
* moe    — pre-norm GQA attention + top-k MoE MLP (``models/moe.py``);
* mamba2 — pre-norm Mamba2 (SSD) mixer.

Hybrid models (Zamba2) put one weight-shared dense block after every
``shared_attn_every`` mamba2 blocks (see ``model.py``), or, in Zamba2's own
form, a :class:`SharedBlock` before each Mamba2 layer that
``hybrid_layer_ids`` names: attention over the stream concatenated with
the embeddings, then a gated MLP with the use's LoRA adapter, no residual,
and the use's linear map into the Mamba2 layer's input; the vlm and audio
families are stacks of dense blocks (M-RoPE, or non-causal attention).
The parameter declarations (``*_param_defs``) keep the reference's shapes
and init kinds; the modules hold them as ``nn.Parameter``s, and the
``apply_*`` functions keep the reference's names and bodies, with each
module's ``forward`` and ``decode`` calling them.  Under tracing
(:mod:`repro_torch.obs.trace`) each attention sublayer is an
``attention`` span, each Mamba2 layer a ``mamba`` span counting the bytes
of recurrent state it reads and writes (``mamba.state_bytes``), and each
use of a Zamba2 shared block a ``hybrid.shared`` span (``use``,
``block``) over its ``attention`` and ``hybrid.mlp`` spans.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.launch.partitioning import gathered, logical_constraint
from repro_torch.models.attention import decode_gqa_attention
from repro_torch.models.layers import (apply_mrope, apply_rope, rmsnorm,
                                      swiglu)
from repro_torch.models.mamba2 import mamba2_decode, mamba2_mixer
from repro_torch.models.moe import moe_block, moe_block_local
from repro_torch.models.params import ParamDef, ParamModule
from repro_torch.obs import trace as _obs

__all__ = [
    "CONV_KW", "attn_param_defs", "mlp_param_defs", "moe_param_defs",
    "mamba2_param_defs", "dense_block_defs", "moe_block_defs",
    "mamba2_block_defs", "shared_block_defs", "use_param_defs",
    "DenseBlock", "MoEBlock", "Mamba2Block", "SharedBlock",
    "apply_attn", "apply_attn_decode", "apply_dense_block",
    "apply_dense_block_decode", "apply_moe_block", "apply_moe_block_decode",
    "apply_mamba2_block", "apply_mamba2_block_decode",
    "apply_shared_block", "apply_shared_block_decode", "STATE_BYTES",
]

CONV_KW = 4  # Mamba2 depthwise conv kernel width
# the tracer's count of recurrent state bytes, on the ``mamba`` span
STATE_BYTES = "mamba.state_bytes"
_NOSPAN = contextlib.nullcontext()      # a span's context while untraced


# ---------------------------------------------------------------------------
# parameter declarations
# ---------------------------------------------------------------------------


def attn_param_defs(cfg, d_in: Optional[int] = None) -> Dict[str, ParamDef]:
    """Attention reading a ``d_in``-wide input (default ``d_model``) and
    writing ``d_model``."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Din = d_in or D
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    p = {
        "ln": ParamDef((Din,), (None,), init="ones"),
        "wq": ParamDef((Din, H * hd), ("embed_fsdp", "heads")),
        "wk": ParamDef((Din, K * hd), ("embed_fsdp", "heads")),
        "wv": ParamDef((Din, K * hd), ("embed_fsdp", "heads")),
        "wo": ParamDef((H * hd, D), ("heads", "embed_fsdp"),
                       init_scale=out_scale),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef((hd,), (None,), init="ones")
        p["k_norm"] = ParamDef((hd,), (None,), init="ones")
    return p


def mlp_param_defs(cfg) -> Dict[str, ParamDef]:
    D, F = cfg.d_model, cfg.d_ff
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((D,), (None,), init="ones"),
        "w_gate": ParamDef((D, F), ("embed_fsdp", "ff")),
        "w_up": ParamDef((D, F), ("embed_fsdp", "ff")),
        "w_down": ParamDef((F, D), ("ff", "embed_fsdp"),
                           init_scale=out_scale),
    }


def moe_param_defs(cfg) -> Dict[str, ParamDef]:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    out_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    return {
        "ln": ParamDef((D,), (None,), init="ones"),
        "router": ParamDef((D, E), ("embed_fsdp", None)),
        "w_gate": ParamDef((E, D, F), ("expert", "embed_fsdp", None)),
        "w_up": ParamDef((E, D, F), ("expert", "embed_fsdp", None)),
        "w_down": ParamDef((E, F, D), ("expert", None, "embed_fsdp"),
                           init_scale=out_scale),
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
        "ln": ParamDef((D,), (None,), init="ones"),
        "in_proj": ParamDef((D, zdim), ("embed_fsdp", "ssm_inner")),
        "conv_w": ParamDef((conv_dim, CONV_KW), ("ssm_inner", None),
                           init_scale=0.1),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), init="zeros"),
        "dt_bias": ParamDef((H,), (None,), custom_init=dt_bias_init),
        "A_log": ParamDef((H,), (None,), custom_init=a_log_init),
        "D": ParamDef((H,), (None,), init="ones"),
        "norm_scale": ParamDef((din,), ("ssm_inner",), init="ones"),
        "out_proj": ParamDef((din, D), ("ssm_inner", "embed_fsdp"),
                             init_scale=out_scale),
    }


def dense_block_defs(cfg) -> Dict[str, Dict[str, ParamDef]]:
    return {"attn": attn_param_defs(cfg), "mlp": mlp_param_defs(cfg)}


def moe_block_defs(cfg) -> Dict[str, Dict[str, ParamDef]]:
    return {"attn": attn_param_defs(cfg), "moe": moe_param_defs(cfg)}


def mamba2_block_defs(cfg) -> Dict[str, Dict[str, ParamDef]]:
    return {"mamba": mamba2_param_defs(cfg)}


def shared_block_defs(cfg) -> Dict[str, Dict[str, ParamDef]]:
    """A Zamba2 shared block: attention over ``cfg.attn_in`` columns and the
    gated MLP."""
    return {"attn": attn_param_defs(cfg, cfg.attn_in),
            "mlp": mlp_param_defs(cfg)}


def use_param_defs(cfg) -> Dict[str, ParamDef]:
    """One use of a Zamba2 shared block: its LoRA adapter on the MLP's gate
    and up products (``x A B``, rank ``adapter_rank``) and its linear map
    of the block's output."""
    D, F, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    return {
        "adapter_a": ParamDef((D, r), ("embed_fsdp", None)),
        "adapter_gate": ParamDef((r, F), (None, "ff")),
        "adapter_up": ParamDef((r, F), (None, "ff")),
        "linear": ParamDef((D, D), ("embed_fsdp", None)),
    }


# ---------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------


def _split_heads(x, n: int):
    """(B, S, n·hd) → (B, S, n, hd).  A DTensor whose last dimension is
    split over a mesh axis that ``n`` heads do not divide is first gathered
    on that axis (whole heads per device)."""
    if isinstance(x, DTensor):
        pl = [Replicate() if p == Shard(2) and n % m else p
              for p, m in zip(x.placements, x.device_mesh.shape)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(x.shape[0], x.shape[1], n, x.shape[2] // n)


def _project_qkv(p, cfg, h):
    H, K = cfg.n_heads, cfg.n_kv_heads
    dtype = h.dtype
    q = _split_heads(h @ gathered(p.wq, dtype), H)
    k = _split_heads(h @ gathered(p.wk, dtype), K)
    v = _split_heads(h @ gathered(p.wv, dtype), K)
    q = logical_constraint(q, "batch", None, "q_heads", None)
    k = logical_constraint(k, "batch", None, "kv_heads", None)
    v = logical_constraint(v, "batch", None, "kv_heads", None)
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
    if _obs.enabled:
        with _obs.span("attention"):
            return _attn(p, cfg, h, positions, window, return_kv)
    return _attn(p, cfg, h, positions, window, return_kv)


def _attn(p, cfg, h, positions, window, return_kv):
    out, kv = _attend(p, cfg, h, positions, window)
    return _residual(h + out), (kv if return_kv else None)


def _attend(p, cfg, x, positions, window, zamba=False):
    """Prefill attention without its residual: ``(out (B, S, d_model),
    (k, v))``; ``zamba``: a Zamba2 shared block's, without RoPE and at
    ``cfg.attn_scale``."""
    x = rmsnorm(x, p.ln, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, x)
    if not zamba:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    out = attn_ops.flash_attention(q, k, v, causal=cfg.causal, window=window,
                                   scale=cfg.attn_scale if zamba else None)
    B, S = out.shape[:2]
    return (out.reshape(B, S, cfg.n_heads * cfg.hd)
            @ gathered(p.wo, x.dtype)), (k, v)


def apply_attn_decode(p, cfg, h: torch.Tensor, pos: torch.Tensor,
                      cache_k: torch.Tensor, cache_v: torch.Tensor,
                      kv_positions: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Decode attention sublayer; writes this token's K/V into the cache in
    place.  ``kv_positions`` already holds the current token (updated once
    per step, before the layers)."""
    if _obs.enabled:
        with _obs.span("attention"):
            return _attn_decode(p, cfg, h, pos, cache_k, cache_v,
                                kv_positions, window)
    return _attn_decode(p, cfg, h, pos, cache_k, cache_v, kv_positions,
                        window)


def _attn_decode(p, cfg, h, pos, cache_k, cache_v, kv_positions, window):
    return _residual(h + _attend_decode(p, cfg, h, pos, cache_k, cache_v,
                                        kv_positions, window))


def _attend_decode(p, cfg, x, pos, cache_k, cache_v, kv_positions, window,
                   zamba=False):
    """Decode attention without its residual (B, 1, d_model); ``zamba`` as
    :func:`_attend`."""
    x = rmsnorm(x, p.ln, cfg.norm_eps)
    q, k, v = _project_qkv(p, cfg, x)
    if not zamba:
        positions = pos[:, None]
        if cfg.mrope_sections is not None:  # one id on all three axes
            positions = pos[:, None, None].expand(pos.shape[0], 1, 3)
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    out = decode_gqa_attention(q, cache_k, cache_v, kv_positions, pos,
                               window=window, k_new=k, v_new=v,
                               scale=cfg.attn_scale if zamba else None)
    out = out.reshape(x.shape[0], 1, cfg.n_heads * cfg.hd)
    return out @ gathered(p.wo, x.dtype)


def _residual(h):
    """The residual stream after a sublayer: batch-sharded, whole over
    ``model`` (a row-parallel product leaves partial sums, which are
    reduced here rather than carried into the next norm and products)."""
    return logical_constraint(h, "batch", None, None)


def _mlp(p, cfg, h):
    return _residual(h + swiglu(rmsnorm(h, p.ln, cfg.norm_eps), p.w_gate,
                                p.w_up, p.w_down))


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
    return _residual(h + out), aux


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


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def apply_mamba2_block(p, cfg, h, t=None):
    """Prefill Mamba2 block, ``h + mamba(rmsnorm(h + t))``: ``t``, a Zamba2
    use's output, enters the mixer's input only.  Returns ``(h,
    final_ssm_state, conv_tail)``."""
    with _obs.span("mamba") if _obs.enabled else _NOSPAN:
        x = h if t is None else h + t
        out, final_state, conv_tail = mamba2_mixer(
            p.mamba, cfg, rmsnorm(x, p.mamba.ln, cfg.norm_eps))
        if _obs.enabled:   # the states written
            _obs.count(STATE_BYTES, _nbytes(final_state, conv_tail))
    return _residual(h + out), final_state, conv_tail


def apply_mamba2_block_decode(p, cfg, h, conv_state, ssm_state, t=None):
    """Returns ``(h, new_conv_state, new_ssm_state)``; ``t`` as
    :func:`apply_mamba2_block`."""
    with _obs.span("mamba") if _obs.enabled else _NOSPAN:
        x = h if t is None else h + t
        out, new_conv, new_ssm = mamba2_decode(
            p.mamba, cfg, rmsnorm(x, p.mamba.ln, cfg.norm_eps), conv_state,
            ssm_state)
        if _obs.enabled:   # the states read and those written
            _obs.count(STATE_BYTES, _nbytes(conv_state, ssm_state, new_conv,
                                            new_ssm))
    return _residual(h + out), new_conv, new_ssm


def _shared_input(h, x0):
    """A shared block's input: the stream and the embeddings side by
    side."""
    return torch.cat([h, x0], dim=-1)


def _shared_mlp(p, use, cfg, a):
    """The shared block's gated MLP at one use: ``down(gelu(g) * up)`` with
    ``[g, up] = u W + (u A) B``, ``u = rmsnorm(a)`` and ``A, B`` the use's
    adapter."""
    dtype = a.dtype
    u = rmsnorm(a, p.ln, cfg.norm_eps)
    low = u @ gathered(use.adapter_a, dtype)
    g = u @ gathered(p.w_gate, dtype) + low @ gathered(use.adapter_gate, dtype)
    up = u @ gathered(p.w_up, dtype) + low @ gathered(use.adapter_up, dtype)
    return (F.gelu(g) * up) @ gathered(p.w_down, dtype)


def apply_shared_block(p, use, cfg, h, x0, positions, *, u: int, block: int,
                       window=None, return_kv=False):
    """Use ``u`` of Zamba2 shared block ``p`` (number ``block``; ``use`` the
    use's adapter and linear) in prefill: attention over ``concat(h, x0)``,
    the MLP, no residual, the use's linear.  Returns ``(t, (k,
    v) or None)``, ``t`` what the use adds to its Mamba2 layer's input."""
    with _obs.span("hybrid.shared", use=u, block=block) if _obs.enabled \
            else _NOSPAN:
        x = _shared_input(h, x0)
        with _obs.span("attention") if _obs.enabled else _NOSPAN:
            a, kv = _attend(p.attn, cfg, x, positions, window, zamba=True)
        with _obs.span("hybrid.mlp") if _obs.enabled else _NOSPAN:
            m = _shared_mlp(p.mlp, use, cfg, a)
        return m @ gathered(use.linear, m.dtype), (kv if return_kv else None)


def apply_shared_block_decode(p, use, cfg, h, x0, pos, cache_k, cache_v,
                              kv_positions, *, u: int, block: int,
                              window=None):
    """:func:`apply_shared_block` for one token, through the use's KV
    cache (written in place); ``x0`` the token's embedding."""
    with _obs.span("hybrid.shared", use=u, block=block) if _obs.enabled \
            else _NOSPAN:
        x = _shared_input(h, x0)
        with _obs.span("attention") if _obs.enabled else _NOSPAN:
            a = _attend_decode(p.attn, cfg, x, pos, cache_k, cache_v,
                               kv_positions, window, zamba=True)
        with _obs.span("hybrid.mlp") if _obs.enabled else _NOSPAN:
            m = _shared_mlp(p.mlp, use, cfg, a)
        return m @ gathered(use.linear, m.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class DenseBlock(nn.Module):
    """Pre-norm GQA attention + SwiGLU MLP (also Zamba2's shared block)."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        for name, defs in dense_block_defs(cfg).items():
            setattr(self, name, ParamModule(defs, generator, device))

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
        for name, defs in mamba2_block_defs(cfg).items():
            setattr(self, name, ParamModule(defs, generator, device))

    def forward(self, h, t=None):
        return apply_mamba2_block(self, self.cfg, h, t)

    def decode(self, h, conv_state, ssm_state, t=None):
        return apply_mamba2_block_decode(self, self.cfg, h, conv_state,
                                         ssm_state, t)


class SharedBlock(nn.Module):
    """A Zamba2 shared block: attention over ``cfg.attn_in`` columns and the
    gated MLP; each use brings its own adapter and linear
    (:func:`use_param_defs`)."""

    def __init__(self, cfg, generator, device):
        super().__init__()
        self.cfg = cfg
        for name, defs in shared_block_defs(cfg).items():
            setattr(self, name, ParamModule(defs, generator, device))

    def forward(self, use, h, x0, positions, *, u, block, window=None,
                return_kv=False):
        return apply_shared_block(self, use, self.cfg, h, x0, positions,
                                  u=u, block=block, window=window,
                                  return_kv=return_kv)

    def decode(self, use, h, x0, pos, cache_k, cache_v, kv_positions, *, u,
               block, window=None):
        return apply_shared_block_decode(self, use, self.cfg, h, x0, pos,
                                         cache_k, cache_v, kv_positions,
                                         u=u, block=block, window=window)
