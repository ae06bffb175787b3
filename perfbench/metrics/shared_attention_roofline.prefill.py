"""Share of its roofline bound reached by the prefill attention of Zamba2's
shared blocks: the bound of causal attention at each prefill's shape at
every use of a block over the device time of the ``flash_attention``
kernels in the prefills (%)."""

from perfbench.counts import flops as F
from perfbench.counts.peaks import bound_s

KERNELS = ("flash_fwd",)    # fa3::flash_fwd_bf16 (and the float32 flash_fwd)
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(rec):
    m = rec["model"]
    uses = len(m.get("hybrid_layer_ids") or ())
    us = sum(end - start for name, start, end, phase in rec["events"]
             if phase == "prefill" and any(k in name for k in KERNELS))
    shapes = rec["shapes"].get("prefill")
    if not uses or not shapes or not us:
        return None
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    size = ITEMSIZE[m["dtype"]]
    bound = sum(uses * bound_s(
        F.attention_flops(B, S, S, H, hd),
        F.attention_bytes(B, S, S, H, K, hd, size)) for B, S in shapes)
    return 100.0 * bound / (us / 1e6)
