"""Run one cell of ``BENCHMARK.json`` once on the card.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as one JSON line, last on
standard output, and the compared numbers beside their limits as the last
lines of standard error.  Exits non-zero, printing no result, without
enough CUDA cards, when the program is not in the checkout, or when a JAX
module was loaded.  Kernel and compiler caches stay in ``build/`` inside
the checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))

    import torch
    from perfbench import harness

    entry = harness.cell_entry(harness.manifest(ROOT), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"perfbench: {args.workload} needs {entry['chips']} CUDA "
              f"card(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, checks = harness.run(ROOT, args.workload, args.seed,
                                 args.seconds, bool(args.trace), STARTED,
                                 chips=entry["chips"])
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
