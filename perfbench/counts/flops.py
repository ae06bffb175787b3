"""Operations and bytes of prefill attention, and a prefill's model FLOPs.

A frozen copy of the port's attention count (``kernels/flash_attention/
ops.py``: ``attended_pairs``, ``flops``, ``io_bytes``), so that a later
change to the program cannot move the yardstick.  Attention counts q.k
and p.v over the pairs inside the causal mask; its bytes read q, k and v
once and write the output once.

Model FLOPs count the work the inputs need: ``2 x`` every weight applied to
a token (a mixture of experts: the router and the top-k experts only; the
LM head only on the last token of each prompt, the one whose logits a
prefill computes), plus attention over the causal pairs.  ``m`` is the
``model`` dict of a ``configs/*.json`` file.
"""

from __future__ import annotations


def attended_pairs(Sq: int, Skv: int) -> int:
    """(query, key) pairs inside the causal mask: key j of query i when
    ``j <= i``."""
    return sum(min(i + 1, Skv) for i in range(Sq))


def attention_flops(B: int, Sq: int, Skv: int, H: int, hd: int) -> int:
    """q.k and p.v, 2 hd each, over the attended pairs."""
    return 4 * hd * B * H * attended_pairs(Sq, Skv)


def attention_bytes(B: int, Sq: int, Skv: int, H: int, K: int, hd: int,
                    itemsize: int) -> int:
    """q, k, v in, the output out."""
    return (2 * B * Sq * H * hd + 2 * B * Skv * K * hd) * itemsize


def hd(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def weights_per_token(m: dict) -> int:
    """Weights applied to each token outside the embedding and the head."""
    D, F = m["d_model"], m["d_ff"]
    attn = D * m["n_heads"] * hd(m) + 2 * D * m["n_kv_heads"] * hd(m) \
        + m["n_heads"] * hd(m) * D
    if m["family"] == "moe":
        mlp = D * m["n_experts"] + m["topk"] * 3 * D * F
    else:
        mlp = 3 * D * F
    return m["n_layers"] * (attn + mlp)


def model_flops_prefill(m: dict, B: int, S: int) -> int:
    """One prefill of B prompts of S tokens: the head on each prompt's last
    token only."""
    head = m["d_model"] * m["vocab"]
    return 2 * weights_per_token(m) * B * S + 2 * head * B \
        + m["n_layers"] * attention_flops(B, S, S, m["n_heads"], hd(m))
