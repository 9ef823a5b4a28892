"""Readings for the limits that decide ``correct``: the compared numbers of
the program, of its lower-precision control and of planted faults, seed by
seed, in one process (the training driver needs no window for them)::

    python3 -m port_bench.calibrate --workload <cell> --seeds 1 2 3 \\
        [--modes program control half_batch]

One JSON line a seed and mode on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json
from typing import List, Optional


def main(argv: Optional[List[str]] = None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--modes", nargs="+", default=["program"])
    ap.add_argument("--seconds", type=float, default=4.0,
                    help="the window of a serving seed")
    args = ap.parse_args(argv)
    from . import harness, run, spec
    run.cache_dirs()
    cell = spec.cell(args.workload)
    dev = harness.device(cell["chips"], device)
    driver = importlib.import_module(
        f"port_bench.drivers.{cell['traffic']['driver']}")
    kwargs = {"seconds": args.seconds} \
        if cell["traffic"]["driver"] == "serve" else {}
    rows = driver.calibrate(cell, args.seeds, args.modes, dev, **kwargs)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
