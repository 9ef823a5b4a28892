"""A ``torch.profiler`` trace of the benchmark's train step, the port of
``perf/profile_step.py``.

``perf/bench.py``'s model, batch and knobs (``BENCH_MODEL``,
``BENCH_LOSS``, ``BENCH_ACCUM``, ``BENCH_QUANT``; argv ``[batch]
[steps]``): one untimed warm-up step, then ``steps`` steps (default 2)
under ``utils/logging.py::trace_capture``, which writes ``trace.json``
(Chrome trace format; Perfetto reads it) under ``--out``. Prints the
files written, the seconds the window took and the seconds its export
took (a step's trace holds ~300,000 records), and ``perf/trace_report.py``'s
table of the window, read from the profiler's raw records
(``perf/trace_read.py::device_rows``), with the busy share (device time
over the window's host-clock time) and ``device`` and ``gpu`` (the
card's name and power limit)::

    python -m clip_finegrained_alignment_tpu_torch.perf.profile_step \\
        [batch] [steps] [--out DIR]

``--device cpu`` is for the tests: the trace holds no device records
there, and the device time and busy share are null.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

from . import bench
from ..models.clip import resolve_device
from ._measure import device_fields, synchronize


def capture(device, steps: int, out: Optional[str] = None,
            batch_size: Optional[int] = None, timings: Optional[dict] = None):
    """``bench.py``'s step (the knobs from the environment) built, one
    warm-up step, then :func:`window` of ``steps`` steps."""
    env = os.environ.get
    model_name, loss = env("BENCH_MODEL", "ViT-B/16"), env("BENCH_LOSS",
                                                           "sparc")
    B, accum = bench.regime(model_name, loss)
    b = bench.build(model_name, loss, batch_size or B,
                    int(env("BENCH_ACCUM") or accum),
                    env("BENCH_QUANT", "none"), device)
    b["step"](b["batch"])               # warm-up: cuBLAS, allocator
    return window(b["step"], b["batch"], steps, device, out, timings)


def window(step, batch, steps: int, device, out: Optional[str] = None,
           timings: Optional[dict] = None):
    """``steps`` calls of ``step(batch)`` under the profiler; with ``out``
    the trace is written to ``out/trace.json``
    (``utils/logging.py::trace_capture``). Returns the finished profiler;
    ``timings`` gets the window's seconds (host clock, to the device's
    last result) and the profiler's stop and export's seconds."""
    import torch

    from ..utils.logging import trace_capture
    synchronize(device)
    profiler = (trace_capture(out) if out is not None else
                torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if device.type == "cuda" else [])]))
    t0 = time.perf_counter()
    with profiler as prof:
        for _ in range(steps):
            step(batch)
        synchronize(device)
        t1 = time.perf_counter()
    if timings is not None:
        timings.update(window_s=t1 - t0, export_s=time.perf_counter() - t1)
    return prof


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=None)
    ap.add_argument("steps", nargs="?", type=int, default=2)
    ap.add_argument("--out", default="profile_step_trace")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from .trace_read import device_rows
    from .trace_report import class_table, format_table

    device = resolve_device(args.device)
    timings: dict = {}
    prof = capture(device, args.steps, args.out, args.batch, timings)
    files = []
    for root, _, names in os.walk(args.out):
        for name in names:
            path = os.path.join(root, name)
            files.append({"path": path, "bytes": os.path.getsize(path)})
            print(f"{os.path.getsize(path):>12} {path}", flush=True)
    table = class_table(device_rows(prof), args.steps)
    on_card = device.type == "cuda"
    if on_card:
        print(format_table(table), flush=True)
    else:
        table["device_ms_per_step"] = None
    out = {**table, "files": files, **timings,
           "busy_share": table["device_ms_per_step"] * args.steps
           / (timings["window_s"] * 1e3) if on_card else None,
           **device_fields(device)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
