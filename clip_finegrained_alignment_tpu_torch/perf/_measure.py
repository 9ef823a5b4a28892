"""What every measuring tool of the port shares: the card's name and power
limit, the device a tool runs on, and the two timers of device work.

* :func:`gpu_line`: ``nvidia-smi --query-gpu=name,power.limit
  --format=csv,noheader`` (the first card), printed beside every number
  a tool takes on the card;
* :func:`device_fields`: ``device`` (the card's name, or ``cpu``) and
  ``gpu`` (:func:`gpu_line`, null on the CPU) for a tool's JSON line;
* :func:`cuda_time_ms`: CUDA events around back-to-back calls;
  :func:`time_ms`: the same on the card, the host clock on the CPU;
* :func:`graph_ms`: the same calls replayed from one CUDA graph, without
  the host's launch cost.

:data:`PEAK_BF16_FLOPS`: one H100 SXM's dense bf16 peak (NVIDIA data
sheet, at 700 W).
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, Optional

PEAK_BF16_FLOPS = 989e12


def gpu_line() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_fields(device) -> Dict[str, Optional[str]]:
    """``device``: the card's name or ``cpu``; ``gpu``: its name and power
    limit (null on the CPU)."""
    import torch
    if device.type != "cuda":
        return {"device": "cpu", "gpu": None}
    return {"device": torch.cuda.get_device_name(device), "gpu": gpu_line()}


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cuda_time_ms(fn: Callable[[], object], reps: int = 20, warmup: int = 3,
                 windows: int = 5) -> float:
    """Median over ``windows`` of the mean time of ``reps`` back-to-back
    calls, from CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def time_ms(fn: Callable[[], object], device, reps: int = 20,
            warmup: int = 1) -> float:
    """The mean time of ``reps`` back-to-back calls after ``warmup``: on
    the card :func:`cuda_time_ms` over one window; on the CPU the host
    clock (a CPU number, for the tests)."""
    if device.type == "cuda":
        return cuda_time_ms(fn, reps=reps, warmup=warmup, windows=1)
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def graph_ms(fn: Callable[[], object], reps: int = 20,
             windows: int = 5) -> float:
    """The card's time per call of ``fn`` without the host's launch cost:
    ``reps`` back-to-back calls captured in one CUDA graph, the median over
    ``windows`` replays (CUDA events) divided by ``reps``. Where the host
    takes longer to launch a call than the card to run it,
    :func:`cuda_time_ms` measures the host; this measures the kernels."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)
