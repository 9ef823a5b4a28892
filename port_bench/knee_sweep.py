"""The serving cell's knee: the highest offered rate at which the served
rate keeps up with the offered one and the backlog does not grow over the
window. One server (the cell's, from ``--seed``) takes a window of
``--seconds`` at each rate in turn::

    python3 -m port_bench.knee_sweep --workload <serving cell> \\
        --rates 100 105 110 115 120 125 130 135 140 --seconds 20

One JSON line a rate: offered and served images a second, p50 / p95 /
p99 latency, the p95 of the last third of the requests over the first
third's (a growing backlog reads well above 1), failures, and the
generator's p95 lateness; then the knee. A rate ``keeps up`` when it served
at least 95 % of its offered images a second, failed nothing, its last
third's p95 is within 1.5× its first third's, and the generator kept to
its schedule (p95 lateness under ``LATE_MS``): a later generator had every
one of its clients waiting on an answer, so the open loop had turned into
a closed one and the queue stood in the generator.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

LATE_MS = 50.0


def main(argv: Optional[List[str]] = None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True,
                    help="offered requests a second")
    args = ap.parse_args(argv)
    from . import harness, run, spec
    from .drivers import serve
    run.cache_dirs()
    cell = spec.cell(args.workload)
    cfg, tr = cell["config"], cell["traffic"]
    dev = harness.device(cell["chips"], device)
    server = serve.start(cfg, tr, args.seed, dev)
    rows, knee = [], None
    try:
        for rate in args.rates:
            out = serve.window(server, serve.loadgen_args(
                cfg, tr, args.seed, server.port, rate, args.seconds, []))
            lat = serve.latencies(out, tr["grace_s"])
            ok = [d is not None and st == 200
                  for d, st in zip(out["done"], out["status"])]
            images = sum(n for n, good in zip(out["images"], ok) if good)
            span = max(d for d in out["done"] if d is not None)
            third = len(lat) // 3
            growth = serve.p(lat[-third:], 0.95) / serve.p(lat[:third], 0.95)
            row = {"offered_requests_per_s": rate,
                   "offered_images_per_s": sum(out["images"]) / args.seconds,
                   "served_images_per_s": images / span,
                   "p50_ms": 1e3 * serve.p(lat, 0.5),
                   "p95_ms": 1e3 * serve.p(lat, 0.95),
                   "p99_ms": 1e3 * serve.p(lat, 0.99),
                   "backlog_growth": growth, "failed": ok.count(False),
                   "fill": out["items"] / max(1, out["batches"]),
                   "send_late_p95_ms": 1e3 * serve.p(
                       [s - d for s, d in zip(out["sent"], out["due"])
                        if s is not None], 0.95)}
            row["keeps_up"] = (
                row["served_images_per_s"] >= 0.95 * row["offered_images_per_s"]
                and not row["failed"] and growth <= 1.5
                and row["send_late_p95_ms"] < LATE_MS)
            if row["keeps_up"]:
                knee = rate
            rows.append(row)
            print(json.dumps(row), flush=True)
    finally:
        server.close()
    print(json.dumps({"knee_requests_per_s": knee,
                      "mean_images_a_request": sum(
                          s * w for s, w in zip(tr["sizes"], tr["weights"]))
                      / sum(tr["weights"])}), flush=True)
    return rows


if __name__ == "__main__":
    main()
