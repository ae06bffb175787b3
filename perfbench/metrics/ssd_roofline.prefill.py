"""Share of its roofline bound reached by the prefill's SSD scans: the
bound of the scan at each prefill's shape in every Mamba2 layer over the
device time of the ``ssd`` kernels in the prefills (%)."""

from perfbench.counts import hybrid as Y
from perfbench.counts.peaks import bound_s

KERNELS = ("ssd3::", "ssd_fwd")  # bf16 states / pass / scan, float32 ssd_fwd
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def read(rec):
    m = rec["model"]
    us = sum(end - start for name, start, end, phase in rec["events"]
             if phase == "prefill" and any(k in name for k in KERNELS))
    shapes = rec["shapes"].get("prefill")
    if not m.get("ssm_state") or not shapes or not us:
        return None
    _, H, P, G, N = Y.ssm_widths(m)
    size = ITEMSIZE[m["dtype"]]
    bound = sum(m["n_layers"] * bound_s(
        Y.ssd_flops(B, S, H, P, N), Y.ssd_bytes(B, S, H, P, G, N, size))
        for B, S in shapes)
    return 100.0 * bound / (us / 1e6)
