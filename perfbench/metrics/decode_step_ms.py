"""Wall time of a decode step, from the harness's span around each
``decode_step`` call ending in the host read of its tokens (ms)."""


def read(rec):
    spans = rec["spans"].get("decode")
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e3
