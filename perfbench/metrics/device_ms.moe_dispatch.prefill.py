"""Device time per prefill batch of the MoE dispatch and combine: the
stable sort of expert ids, the token gathers, the buffer scatter and the
inverse permutation, classified by kernel name, first match in order (ms)."""

KINDS = (("lm", ("flash_",)),
         ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
         ("dispatch", ("Sort", "sort", "Radix", "radix", "index", "Index",
                       "gather", "Gather", "scatter", "Scatter")))


def kind(name):
    return next((k for k, keys in KINDS if any(x in name for x in keys)),
                "other")


def read(rec):
    prefills = rec["spans"].get("prefill")
    if not prefills:
        return None
    us = sum(end - start for name, start, end, phase in rec["events"]
             if phase == "prefill" and kind(name) == "dispatch")
    return us / 1e3 / len(prefills)
