"""Plain float32 PyTorch pieces shared by the model families' references.

Written from the published descriptions; the program's own choices that a
reference must follow to compute the same function (its parameter names
and shapes, the placement of its norms, its rotary layout) are noted where
they are made.  Imports nothing of the program.  Every matrix product goes
through :func:`linear`, which in ``"fp8"`` computes on operands rounded to
float8 e4m3 (per-tensor scale): the control of the correctness check, one
precision below the configurations' bfloat16 compute.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0      # largest finite float8 e4m3fn value


def no_tf32() -> None:
    """float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale (the largest
    magnitude maps to 448), back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        return fake_fp8(x) @ fake_fp8(w)
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, hd) at integer positions (B, S),
    rotating the first half of each head against the second (the program's
    layout; the same function as interleaved pairs up to a permutation of
    the head's dimensions)."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = positions.float()[..., None] * inv
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor,
              block: int = 1024) -> torch.Tensor:
    """Causal softmax attention: query i attends to key j when ``k_pos[j]
    <= q_pos[i]``.  q (B, Sq, H, hd); k, v (B, Sk, K, hd) with query head h
    reading key head ``h // (H / K)``; positions (Sq,) and (Sk,).  Computed
    one batch row and ``block`` queries at a time, so that it fits."""
    B, Sq, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2) if rep > 1 else k
    v = v.repeat_interleave(rep, dim=2) if rep > 1 else v
    scale = 1.0 / math.sqrt(hd)
    rows = []
    for b in range(B):
        parts = []
        for s0 in range(0, Sq, block):
            qb = q[b, s0:s0 + block]                       # (s, H, hd)
            s = torch.einsum("qhd,khd->hqk", qb * scale, k[b])
            mask = k_pos[None, :] <= q_pos[s0:s0 + block, None]
            s = s.masked_fill(~mask[None], float("-inf"))
            parts.append(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                      v[b]))
        rows.append(torch.cat(parts, dim=0))
    return torch.stack(rows)


def swiglu(x, w_gate, w_up, w_down, precision):
    return linear(F.silu(linear(x, w_gate, precision))
                  * linear(x, w_up, precision), w_down, precision)


def attention_sublayer(p: dict, m: dict, h: torch.Tensor,
                       positions: torch.Tensor, precision: str,
                       cache: dict | None = None):
    """Pre-norm multi-head attention with rotary positions and a residual.
    ``positions`` (S,) are the tokens' positions; ``cache`` (a dict with
    ``k``, ``v``, ``pos`` or empty) holds the keys and values of earlier
    tokens and gains this call's.  ``p`` maps ``ln, wq, wk, wv, wo``."""
    B, S, _ = h.shape
    H, K = m["n_heads"], m["n_kv_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    u = rmsnorm(h, p["ln"], m["norm_eps"])
    pos2 = positions[None].expand(B, S)
    q = rope(linear(u, p["wq"], precision).reshape(B, S, H, hd), pos2,
             m["rope_theta"])
    k = rope(linear(u, p["wk"], precision).reshape(B, S, K, hd), pos2,
             m["rope_theta"])
    v = linear(u, p["wv"], precision).reshape(B, S, K, hd)
    if cache is not None:
        if cache:
            k = torch.cat([cache["k"], k], dim=1)
            v = torch.cat([cache["v"], v], dim=1)
            positions_k = torch.cat([cache["pos"], positions])
        else:
            positions_k = positions
        cache.update(k=k, v=v, pos=positions_k)
    else:
        positions_k = positions
    out = attention(q, k, v, positions, positions_k)
    return h + linear(out.reshape(B, S, H * hd), p["wo"], precision)


def head_logits(params: dict, m: dict, h: torch.Tensor,
                precision: str) -> torch.Tensor:
    return linear(rmsnorm(h, params["final_ln"], m["norm_eps"]),
                  params["head"], precision)


def sub(params: dict, prefix: str) -> dict:
    """The entries of ``params`` under ``prefix.``, with it removed."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}
