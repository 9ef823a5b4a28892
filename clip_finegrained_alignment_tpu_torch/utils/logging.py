"""Step timing, throughput metering, metrics and traces: the port of
``clip_finegrained_alignment_tpu/utils/logging.py``.

* ``StepTimer``: named wall-clock spans that are also
  ``torch.profiler.record_function`` ranges, so the same names appear on a
  captured trace's timeline.
* ``ThroughputMeter``: pairs/s per card with rolling statistics.
* ``MetricsLogger``: one JSON record a line (``step``, ``time`` and the
  metrics), the JAX package's records.
* ``trace_capture``: a ``torch.profiler`` trace of the enclosed block,
  written as a Chrome trace, in place of ``jax.profiler``.

Rank-0 gating uses ``torch.distributed``'s rank (0 without a process
group).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from collections import deque
from typing import Dict, Optional

import torch

from ..parallel import mesh


def is_main_process() -> bool:
    return mesh.rank() == 0


class StepTimer:
    """Named step timestamps and profiler ranges.

    >>> timer = StepTimer()
    >>> with timer.span("all_gather"):
    ...     ...
    >>> timer.log_step("epoch_start")          # point-in-time stamp
    """

    def __init__(self, echo: bool = True):
        self.stamps: Dict[str, float] = {}
        self.durations: Dict[str, float] = {}
        self.echo = echo

    def log_step(self, name: str) -> None:
        """Point stamp."""
        t = time.time()
        self.stamps[name] = t
        if self.echo and is_main_process():
            print(f"[step] {name}: {t:.3f}", flush=True)

    @contextlib.contextmanager
    def span(self, name: str):
        """Timed span, on stdout and on the profiler's timeline. The host
        clock: it measures the device only where the span synchronizes."""
        start = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.durations[name] = time.perf_counter() - start
        if self.echo and is_main_process():
            print(f"[span] {name}: {self.durations[name] * 1e3:.1f} ms",
                  flush=True)


class ThroughputMeter:
    """Rolling pairs/s per card."""

    def __init__(self, window: int = 50, num_chips: Optional[int] = None):
        self.window = deque(maxlen=window)
        self.num_chips = num_chips or mesh.world_size()
        self._last: Optional[float] = None

    def tick(self, num_pairs: int) -> Optional[float]:
        """Call once a step with the global pair count; returns the
        current pairs/s per card (None on the first tick)."""
        now = time.perf_counter()
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self.window.append(num_pairs / dt / self.num_chips)
        return self.window[-1]

    @property
    def mean(self) -> float:
        return sum(self.window) / len(self.window) if self.window else 0.0

    def report(self) -> Dict[str, float]:
        return {"pairs_per_sec_per_chip": self.mean,
                "num_chips": self.num_chips,
                "window": len(self.window)}


@contextlib.contextmanager
def trace_capture(logdir: str):
    """A ``torch.profiler`` trace (CPU, and CUDA where there is a card) of
    the enclosed block, written to ``<logdir>/trace.json`` (Chrome trace
    format, which Perfetto reads)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLogger:
    """JSONL metrics stream (one record a ``log`` call), echoed to
    stderr."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = open(path, "a") if path and is_main_process() else None

    def log(self, step: int, **metrics) -> None:
        if not is_main_process():
            return
        rec = {"step": step, "time": time.time(), **{
            k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float))
                else v) for k, v in metrics.items()}}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float)
                             else f"{k}={v}" for k, v in rec.items()
                             if k != "time")
            print(parts, file=sys.stderr, flush=True)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
