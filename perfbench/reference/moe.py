"""Plain float32 reference of the MoE family (OLMoE, arXiv:2409.02060) as
the configuration runs it: pre-norm attention with rotary positions, then
a top-k mixture of SwiGLU experts, an untied LM head; served as a prefill
and then one token a step through a cache.

Departures from the published OLMoE, all the program's and followed here:

* no QK-norm (the configuration's ``qk_norm`` is false);
* the top-k gates are renormalised to sum to 1;
* each expert takes at most ``C`` tokens of a routing group, the first in
  token order (row-major over batch and sequence); the rest of a token's
  choices beyond an expert's capacity are dropped and add nothing.  A
  prefill routes all of its batch's tokens as one group; a decode step
  routes its batch's one token a row as one group.  ``C`` is the program's
  rule: ``k T / E`` times the capacity factor, rounded up to a multiple of
  8, at least 8.

Experts run one at a time over the tokens they keep, so that float32
activations fit beside the weights.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.common import (attention_sublayer, head_logits,
                                        rmsnorm, sub, swiglu)


def param_defs(m: dict) -> dict:
    """``{name: (shape, init, scale)}`` under the program's names."""
    D, V, L, F_ = m["d_model"], m["vocab"], m["n_layers"], m["d_ff"]
    H, K, E = m["n_heads"], m["n_kv_heads"], m["n_experts"]
    hd = m.get("head_dim") or D // H
    out_scale = 0.02 / math.sqrt(2 * L)
    defs = {"embed": ((V, D), "normal", 0.02)}
    for i in range(L):
        b = f"blocks.{i}."
        defs.update({
            b + "attn.ln": ((D,), "ones", 0),
            b + "attn.wq": ((D, H * hd), "normal", 0.02),
            b + "attn.wk": ((D, K * hd), "normal", 0.02),
            b + "attn.wv": ((D, K * hd), "normal", 0.02),
            b + "attn.wo": ((H * hd, D), "normal", out_scale),
            b + "moe.ln": ((D,), "ones", 0),
            b + "moe.router": ((D, E), "normal", 0.02),
            b + "moe.w_gate": ((E, D, F_), "normal", 0.02),
            b + "moe.w_up": ((E, D, F_), "normal", 0.02),
            b + "moe.w_down": ((E, F_, D), "normal", out_scale)})
    defs.update({"final_ln": ((D,), "ones", 0),
                 "head": ((D, V), "normal", 0.02)})
    return defs


def capacity(tokens: int, m: dict) -> int:
    c = int(tokens * m["topk"] / m["n_experts"] * m["capacity_factor"])
    return max(-(-c // 8) * 8, 8)


def experts(p: dict, m: dict, x: torch.Tensor, precision: str):
    """The mixture over routing groups x (G, T, D): each group's tokens are
    routed with the capacity of T tokens."""
    G, T, D = x.shape
    k, E = m["topk"], m["n_experts"]
    C = capacity(T, m)
    probs = torch.softmax(x @ p["router"], dim=-1)          # (G, T, E)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    chosen = torch.zeros_like(probs).scatter_(2, idx, 1.0)  # (G, T, E)
    before = torch.cumsum(chosen, dim=1) - chosen           # earlier tokens
    keep = torch.gather(before, 2, idx) < C                 # (G, T, k)
    weight = torch.zeros_like(probs).scatter_(2, idx, gate * keep)
    xf, wf = x.reshape(G * T, D), weight.reshape(G * T, E)
    y = torch.zeros_like(xf)
    for e in range(E):
        rows = torch.nonzero(wf[:, e]).squeeze(1)
        if rows.numel():
            out = swiglu(xf[rows], p["w_gate"][e], p["w_up"][e],
                         p["w_down"][e], precision)
            y.index_add_(0, rows, out * wf[rows, e, None])
    return y.reshape(G, T, D)


def _layer(params, m, i, h, positions, cache, precision, groups):
    h = attention_sublayer(sub(params, f"blocks.{i}.attn"), m, h, positions,
                           precision, cache)
    p = sub(params, f"blocks.{i}.moe")
    B, S, D = h.shape
    u = rmsnorm(h, p["ln"], m["norm_eps"])
    # prefill: one group of all B x S tokens; decode: one group a position
    x = u.reshape(1, B * S, D) if groups == "batch" else u.transpose(0, 1)
    y = experts(p, m, x, precision)
    y = y.reshape(B, S, D) if groups == "batch" else y.transpose(0, 1)
    return h + y


@torch.no_grad()
def serve_logits(params: dict, m: dict, prompts: torch.Tensor,
                 served: torch.Tensor, precision="f32") -> torch.Tensor:
    """Logits (B, n, V) of each served token's position: the prefill of
    ``prompts`` (B, S) gives the first; the served tokens (B, n) fed back
    one step at a time give the others (teacher forcing, one decode step's
    routing group a position)."""
    B, S = prompts.shape
    dev = prompts.device
    caches = [dict() for _ in range(m["n_layers"])]
    h = params["embed"][prompts.long()]
    pos = torch.arange(S, device=dev)
    for i in range(m["n_layers"]):
        h = _layer(params, m, i, h, pos, caches[i], precision, "batch")
    first = head_logits(params, m, h[:, -1:], precision)
    n = served.shape[1]
    if n == 1:
        return first
    h = params["embed"][served[:, :-1].long()]
    pos = torch.arange(S, S + n - 1, device=dev)
    for i in range(m["n_layers"]):
        h = _layer(params, m, i, h, pos, caches[i], precision, "position")
    return torch.cat([first, head_logits(params, m, h, precision)], dim=1)
