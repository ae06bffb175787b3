"""Model FLOPs of the window's prefills of Zamba2's form over the bf16
peak times their wall time, each from its batch's start to the host read
of its first tokens (%): the share of the whole prefill step."""

from perfbench.counts.hybrid import model_flops_prefill
from perfbench.counts.peaks import BF16_FLOPS_PER_S


def read(rec):
    spans = rec["spans"].get("prefill")
    if not spans or not rec["model"].get("hybrid_layer_ids"):
        return None
    work = sum(model_flops_prefill(rec["model"], B, S)
               for B, S in rec["shapes"]["prefill"])
    seconds = sum(e - s for s, e in spans)
    return 100.0 * work / (BF16_FLOPS_PER_S * seconds)
