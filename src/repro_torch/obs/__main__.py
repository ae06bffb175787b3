"""CLI: ``python -m repro_torch.obs summarize <trace>``.

Reads a trace exported by :mod:`repro_torch.obs.export` (Chrome-trace JSON or
JSONL) and prints the per-tag time/dispatch/compile breakdown.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.obs.export import read_events, summarize


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.obs")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_sum = sub.add_parser(
        "summarize",
        help="per-tag time/dispatch/compile breakdown of a trace file")
    p_sum.add_argument("trace",
                       help="Chrome-trace JSON or JSONL event log")
    args = parser.parse_args(argv)
    if args.cmd == "summarize":
        print(summarize(read_events(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
