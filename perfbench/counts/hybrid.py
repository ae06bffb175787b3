"""Operations and bytes of the SSD scan, and a prefill's model FLOPs, of
the hybrid family in Zamba2's form.

A frozen copy of the port's scan count (``kernels/ssd/ops.py``: ``flops``,
``io_bytes``), so that a later change to the program cannot move the
yardstick: per head, in 64-row sub-chunks, C.B and G.x over the lower
triangle, C.state and the state update in full; its bytes read x, a, B, C
once and write y and the float32 final state once.

Model FLOPs count the work the inputs need: ``2 x`` every weight applied
to a token (each Mamba2 layer's projections and conv, and at each use of
a shared block the block's attention and MLP, the use's adapter and its
linear), the LM head only on each prompt's last token, causal attention
at every use, and the scan in every Mamba2 layer.  ``m`` is the ``model``
dict of a ``configs/*.json`` file.
"""

from __future__ import annotations

from perfbench.counts.flops import attention_flops

SUB = 64             # the count's fixed sub-chunk
CONV = 4             # Mamba2's conv width


def ssm_widths(m: dict):
    """``(d_inner, heads, head dim, groups, state)`` of a Mamba2 layer."""
    din = m["ssm_expand"] * m["d_model"]
    return (din, din // m["ssm_headdim"], m["ssm_headdim"], m["ssm_groups"],
            m["ssm_state"])


def ssd_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    T = SUB
    return B * H * -(-S // T) * (T * (T + 1) * (N + P) + 4 * T * P * N)


def ssd_bytes(B: int, S: int, H: int, P: int, G: int, N: int,
              itemsize: int) -> int:
    return (2 * B * S * H * P + B * S * H + 2 * B * S * G * N) * itemsize \
        + B * H * P * N * 4


def weights_per_token(m: dict) -> int:
    """Weights applied to each token outside the embedding and the head."""
    D, F, r = m["d_model"], m["d_ff"], m["adapter_rank"]
    din, Hs, _, G, N = ssm_widths(m)
    conv_dim = din + 2 * G * N
    mamba = D * (2 * din + 2 * G * N + Hs) + conv_dim * CONV \
        + din * D
    Din = 2 * D                         # the stream and the embeddings
    hq, hk = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    block = Din * (hq + 2 * hk) + hq * D + 3 * D * F
    use = D * r + 2 * r * F + D * D
    return m["n_layers"] * mamba + len(m["hybrid_layer_ids"]) * (block + use)


def model_flops_prefill(m: dict, B: int, S: int) -> int:
    """One prefill of B prompts of S tokens: the head on each prompt's last
    token only."""
    _, Hs, P, _, N = ssm_widths(m)
    head = m["d_model"] * m["vocab"]
    return 2 * weights_per_token(m) * B * S + 2 * head * B \
        + len(m["hybrid_layer_ids"]) * attention_flops(
            B, S, S, m["n_heads"], m["head_dim"]) \
        + m["n_layers"] * ssd_flops(B, S, Hs, P, N)
