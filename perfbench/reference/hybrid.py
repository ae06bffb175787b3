"""Plain float32 reference of the hybrid family as Zyphra's Zamba2 runs it
(Zamba2-2.7B: https://huggingface.co/Zyphra/Zamba2-2.7B, its
``config.json`` and ``transformers``' ``modeling_zamba2.py``; the Zamba2
suite, arXiv:2411.15242; Zamba, arXiv:2405.16712, eq. 6): a stack of Mamba2
layers, before some of which a weight-shared transformer block reads the
stream and the embeddings side by side; an untied LM head; served as a
prefill and then one token a step, which here is the full forward over
the prompt and the served tokens (teacher forcing).

Layer ``i`` of ``n_layers`` (``x0`` the embeddings, kept for the whole
forward): if ``i`` is the ``u``-th of ``hybrid_layer_ids``, shared block
``b = u % num_mem_blocks`` runs on ``c = concat(h, x0)``:
``a = o_proj(attn(rmsnorm(c)))``, causal multi-head attention without
RoPE (the 2.7B's ``use_mem_rope`` false) at the softmax scale
``(head_dim / 2) ** -0.5`` (the concatenation doubles the width),
then ``m = down(gelu(g) * up)`` with ``[g, up] = rmsnorm(a) W +
(rmsnorm(a) A_u) B_u`` (use ``u``'s own rank-``adapter_rank`` adapter),
no residual inside the block, and ``t = m L_u`` (use ``u``'s own
``d_model x d_model`` matrix).  Then ``h = h + mamba(rmsnorm(h + t))``,
``t = 0`` on the other layers: the shared block's output enters the Mamba2
layer's input only.

The Mamba2 layer is the plain recurrence ``h_t = exp(dt_t A) h_{t-1} +
dt_t B_t x_t``, ``y_t = C_t h_t + D x_t`` with ``dt = softplus(dt_raw +
dt_bias)``, ``A = -exp(A_log)``, computed in plain chunks of
:data:`CHUNK` steps (within a chunk its closed form; the state carried
from chunk to chunk), after a causal depthwise conv of width :data:`CONV`
with bias and SiLU, and followed by the gated RMSNorm ``rmsnorm(y *
silu(z))`` and the out projection.

Departures from Zyphra's model, all the program's and followed here:

* the LM head is untied from the embeddings;
* parameter names and layouts are the program's: the in-projection's
  columns are ``[z, x, B, C, dt]``, the conv weight ``(channels, width)``,
  the shared MLP's gate and up products (and each adapter's) two matrices
  where Zyphra's hold one ``gate_up`` of twice the width, gate first;
* the weights are seeded draws (:func:`param_defs`), not Zyphra's:
  normals (``A_log`` and ``dt_bias`` included, where Zyphra initialises
  ``A`` in ``-[1, 16]`` and ``dt`` in ``[1e-3, 0.1]``) and ones for the
  norms and ``D``.

Every matrix product goes through :func:`common.linear`, so ``"fp8"`` is
the control one precision below the configuration's bfloat16.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import (attention, head_logits, linear,
                                        rmsnorm, sub)

CHUNK = 128          # steps of the recurrence in one closed-form chunk
CONV = 4             # Mamba2's conv width (config.json's conv_kernel)


def _widths(m: dict):
    D = m["d_model"]
    din = m["ssm_expand"] * D
    G, N, P = m["ssm_groups"], m["ssm_state"], m["ssm_headdim"]
    return D, din, G, N, P, din // P


def param_defs(m: dict) -> dict:
    """``{name: (shape, init, scale)}`` under the program's names.  Normal
    draws of scale ``fan_in ** -0.5``, so that every product keeps its
    input's scale at any width (at Zamba2-2.7B's 2560 about the usual
    0.02), apart from: the embeddings at 1; each Mamba2 layer's out
    projection at ``(fan_in * n_layers) ** -0.5``, so that the stream
    stays near the embeddings' scale and ``x0`` counts in the
    concatenation to the last layer; the adapters' second matrices at half
    their scale (an adapter moves its MLP, it does not replace it);
    ``A_log`` at 1.5 (decays from a few to about a hundred steps) and
    ``dt_bias`` at 0.5."""
    D, din, G, N, P, Hs = _widths(m)
    V, L, F_ = m["vocab"], m["n_layers"], m["d_ff"]
    H, K, hd, r = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
        m["adapter_rank"]
    conv_dim, kw = din + 2 * G * N, CONV
    fan = lambda n: n ** -0.5  # noqa: E731
    defs = {"embed": ((V, D), "normal", 1.0)}
    for i in range(L):
        b = f"blocks.{i}.mamba."
        defs.update({
            b + "ln": ((D,), "ones", 0),
            b + "in_proj": ((D, 2 * din + 2 * G * N + Hs), "normal",
                            fan(D)),
            b + "conv_w": ((conv_dim, kw), "normal", fan(kw)),
            b + "conv_b": ((conv_dim,), "normal", 0.1),
            b + "dt_bias": ((Hs,), "normal", 0.5),
            b + "A_log": ((Hs,), "normal", 1.5),
            b + "D": ((Hs,), "ones", 0),
            b + "norm_scale": ((din,), "ones", 0),
            b + "out_proj": ((din, D), "normal", fan(din * L))})
    for j in range(m["num_mem_blocks"]):
        s = f"shared.{j}."
        defs.update({
            s + "attn.ln": ((2 * D,), "ones", 0),
            s + "attn.wq": ((2 * D, H * hd), "normal", fan(2 * D)),
            s + "attn.wk": ((2 * D, K * hd), "normal", fan(2 * D)),
            s + "attn.wv": ((2 * D, K * hd), "normal", fan(2 * D)),
            s + "attn.wo": ((H * hd, D), "normal", fan(H * hd)),
            s + "mlp.ln": ((D,), "ones", 0),
            s + "mlp.w_gate": ((D, F_), "normal", fan(D)),
            s + "mlp.w_up": ((D, F_), "normal", fan(D)),
            s + "mlp.w_down": ((F_, D), "normal", fan(F_))})
    for u in range(len(m["hybrid_layer_ids"])):
        s = f"uses.{u}."
        defs.update({
            s + "adapter_a": ((D, r), "normal", fan(D)),
            s + "adapter_gate": ((r, F_), "normal", 0.5 * fan(r)),
            s + "adapter_up": ((r, F_), "normal", 0.5 * fan(r)),
            s + "linear": ((D, D), "normal", fan(D))})
    defs.update({"final_ln": ((D,), "ones", 0),
                 "head": ((D, V), "normal", fan(D))})
    return defs


def scan(x, dt, A, Bm, Cm):
    """The recurrence over x (B, T, H, P) with dt (B, T, H), A (H,) and
    Bm, Cm (B, T, G, N): y (B, T, H, P), chunk by chunk."""
    B_, T, H, P = x.shape
    rep = H // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)                   # (B, T, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    a = dt * A                                              # log decay
    xd = x * dt[..., None]
    state = x.new_zeros(B_, H, P, Bh.shape[-1])
    ys = []
    for t0 in range(0, T, CHUNK):
        sl = slice(t0, t0 + CHUNK)
        cum = torch.cumsum(a[:, sl], dim=1)                 # (B, Q, H)
        Q = cum.shape[1]
        seg = cum[:, :, None] - cum[:, None, :]             # (B, i, j, H)
        past = torch.tril(torch.ones(Q, Q, dtype=torch.bool,
                                     device=x.device))
        decay = torch.exp(seg.masked_fill(~past[None, :, :, None],
                                          float("-inf")))
        w = torch.einsum("bihn,bjhn->bijh", Ch[:, sl], Bh[:, sl]) * decay
        y = torch.einsum("bijh,bjhp->bihp", w, xd[:, sl])
        y = y + torch.einsum("bihn,bhpn->bihp", Ch[:, sl], state) \
            * torch.exp(cum)[..., None]
        last = torch.exp(cum[:, -1:] - cum)[..., None]      # (B, Q, H, 1)
        state = state * torch.exp(cum[:, -1])[..., None, None] \
            + torch.einsum("bjhn,bjhp->bhpn", last * Bh[:, sl], xd[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba(p: dict, m: dict, u: torch.Tensor, precision: str):
    """The Mamba2 mixer of u (B, T, D), already normalised."""
    D, din, G, N, P, Hs = _widths(m)
    B_, T, _ = u.shape
    zxbcdt = linear(u, p["in_proj"], precision)
    conv_dim = din + 2 * G * N
    z, xbc = zxbcdt[..., :din], zxbcdt[..., din:din + conv_dim]
    dt_raw = zxbcdt[..., din + conv_dim:]
    kw = p["conv_w"].shape[1]
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (kw - 1, 0)),
                   p["conv_w"][:, None, :], p["conv_b"], groups=conv_dim)
    xbc = F.silu(xbc.transpose(1, 2))
    x = xbc[..., :din].reshape(B_, T, Hs, P)
    Bm = xbc[..., din:din + G * N].reshape(B_, T, G, N)
    Cm = xbc[..., din + G * N:].reshape(B_, T, G, N)
    dt = F.softplus(dt_raw + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = scan(x, dt, A, Bm, Cm) + p["D"][:, None] * x
    y = rmsnorm(y.reshape(B_, T, din) * F.silu(z), p["norm_scale"],
                m["norm_eps"])
    return linear(y, p["out_proj"], precision)


def shared(params: dict, m: dict, u: int, h, x0, pos, precision: str):
    """Use ``u`` of its shared block: what it adds to its Mamba2 layer's
    input."""
    p = sub(params, f"shared.{u % m['num_mem_blocks']}")
    use = sub(params, f"uses.{u}")
    B_, T, _ = h.shape
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    c = rmsnorm(torch.cat([h, x0], dim=-1), p["attn.ln"], m["norm_eps"])
    q = linear(c, p["attn.wq"], precision).reshape(B_, T, H, hd)
    k = linear(c, p["attn.wk"], precision).reshape(B_, T, K, hd)
    v = linear(c, p["attn.wv"], precision).reshape(B_, T, K, hd)
    # common.attention scales by hd ** -0.5; Zamba2's scale is (hd/2) ** -0.5
    o = attention(q * math.sqrt(2.0), k, v, pos, pos)
    a = linear(o.reshape(B_, T, H * hd), p["attn.wo"], precision)
    n = rmsnorm(a, p["mlp.ln"], m["norm_eps"])
    low = linear(n, use["adapter_a"], precision)
    g = linear(n, p["mlp.w_gate"], precision) \
        + linear(low, use["adapter_gate"], precision)
    up = linear(n, p["mlp.w_up"], precision) \
        + linear(low, use["adapter_up"], precision)
    out = linear(F.gelu(g) * up, p["mlp.w_down"], precision)
    return linear(out, use["linear"], precision)


@torch.no_grad()
def serve_logits(params: dict, m: dict, prompts: torch.Tensor,
                 served: torch.Tensor, precision="f32") -> torch.Tensor:
    """Logits (B, n, V) of each served token's position: the full forward
    over ``prompts`` (B, S) and the served tokens (B, n) but the last, the
    logits read at positions S - 1 .. S + n - 2 (teacher forcing)."""
    S, n = prompts.shape[1], served.shape[1]
    tokens = torch.cat([prompts, served[:, :-1].to(prompts.dtype)], dim=1)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x0 = params["embed"][tokens.long()]
    h = x0
    uses = {i: u for u, i in enumerate(m["hybrid_layer_ids"])}
    for i in range(m["n_layers"]):
        p = sub(params, f"blocks.{i}.mamba")
        x = h
        if i in uses:
            x = h + shared(params, m, uses[i], h, x0, pos, precision)
        h = h + mamba(p, m, rmsnorm(x, p["ln"], m["norm_eps"]), precision)
    return head_logits(params, m, h[:, S - 1:S - 1 + n], precision)
