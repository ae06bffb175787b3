"""``python -m repro_torch.serve`` — run the saturation harness and print JSON.

A quick operator smoke test of the serving stack: seeded multi-tenant
traffic through batched and unbatched servers, the virtual-clock latency
loop, and the cache/compile discipline checks (see
:mod:`repro_torch.serve.bench`).  The servers run on the card unless
``--device cpu`` asks for the plain path.  Exits 0 only if the batched
plans are bitwise equal to the unbatched ones and the warm path built and
loaded nothing.
"""

from __future__ import annotations

import argparse
import json

from repro_torch.serve.bench import run_saturation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "python -m repro_torch.serve",
        description="serve_saturation: multi-tenant micro-batched "
                    "prediction service benchmark")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2048,
                    help="throughput-phase request count")
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="latency-phase open-loop arrival rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the servers (default: the card)")
    args = ap.parse_args(argv)
    out = run_saturation(tenants=args.tenants, n_requests=args.requests,
                         rate_rps=args.rate, seed=args.seed,
                         device=args.device)
    print(json.dumps(out, indent=2, default=str))
    thr = out["throughput"]
    ok = bool(thr["bitwise"]) and bool(
        out["discipline"]["warm_zero_compiles"])
    print(f"# speedup {thr['speedup_x']:.1f}x, "
          f"p99 {out['latency']['p99_ms']:.3f} ms, "
          f"bitwise={thr['bitwise']}, "
          f"warm_zero_compiles={out['discipline']['warm_zero_compiles']}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
