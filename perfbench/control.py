"""Readings that the limits of ``workloads/<cell>.json`` are set from.

  python3 perfbench/control.py --workload <cell> --seeds 11 12 13 ... [--seconds 10]
      [--control-seeds 3]

For each seed, in one process: the program's reading of each compared
number (a window of ``--seconds`` at the cell's own load, whole batches,
then the check's sample of them) and the control's (the reference in
float8 e4m3 put in the program's place, on the same prompts and served
tokens).  The benchmark's own runs never run this.  Prints one JSON line
a seed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def readings(ctx, control: bool = True) -> dict:
    """``{"program": {...}, "control": {...}}`` of one seed (without
    ``control`` the program's alone)."""
    import gc

    import torch
    kind = ctx.kind
    st = kind.setup(ctx)
    w = kind.window(ctx, st, time.perf_counter, None)
    kept = kind.release(st, w)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    batches = kind.checked_batches(ctx, kept)
    return dict(kind.served_gaps(ctx, batches, control=control),
                batches=len(batches),
                served=sum(sum(outs) for _, outs, _ in batches))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first so many seeds only")
    args = ap.parse_args()
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    from perfbench import harness
    from perfbench.reference.common import no_tf32
    no_tf32()
    n = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        ctx = harness.context(ROOT, args.workload, seed, args.seconds,
                              "cuda")
        out = readings(ctx, control=i < n)
        out.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
