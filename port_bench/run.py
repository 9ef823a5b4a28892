"""Run one cell of the benchmark once::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``setup_s`` runs from this process's start to the window's start, the
first run of a checkout's ``nvcc`` build of the port's kernels included;
that build's seconds are also recorded apart, as ``kernel_build_s`` on
standard error (0 in every later run, which finds the libraries built).
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice. Either way the outputs of the timed
path are compared with the plain reference once the window has closed, and
the last line of standard output is the result (``harness.finish``). With
no CUDA card, or fewer than the cell asks for, the run ends with exit code 2
and prints no result.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse       # noqa: E402
import importlib      # noqa: E402
import os             # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernels build into its package's ``_build/``, also inside
    it; these are for PyTorch's and Triton's), and no JAX loaded by a
    library on its own."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ.setdefault(var, str(CHECKOUT / ".port_bench_cache" / sub))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv: Optional[List[str]] = None, device: Optional[str] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    from . import harness, spec
    cell = spec.cell(args.workload)
    dev = harness.device(cell["chips"], device)
    driver = importlib.import_module(
        f"port_bench.drivers.{cell['traffic']['driver']}")
    built = harness.build_kernels(dev)
    out = driver.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                     PROCESS_START)
    out.notes["kernel_build_s"] = built
    return harness.finish(out)


if __name__ == "__main__":
    main()
