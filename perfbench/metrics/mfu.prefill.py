"""Model FLOPs of the window's prefills over the bf16 peak times their wall
time, each from its batch's start to the host read of its first tokens
(%)."""

from perfbench.counts.flops import model_flops_prefill
from perfbench.counts.peaks import BF16_FLOPS_PER_S


def read(rec):
    spans = rec["spans"].get("prefill")
    if not spans:
        return None
    work = sum(model_flops_prefill(rec["model"], B, S)
               for B, S in rec["shapes"]["prefill"])
    seconds = sum(e - s for s, e in spans)
    return 100.0 * work / (BF16_FLOPS_PER_S * seconds)
