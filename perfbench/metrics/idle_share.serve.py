"""Share of the traced serving window in which no operation ran on the
device (%)."""


def read(rec):
    if not rec["spans"].get("prefill"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
