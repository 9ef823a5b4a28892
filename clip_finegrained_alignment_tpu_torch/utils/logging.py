"""Step timing, throughput metering, metrics and traces: the port of
``clip_finegrained_alignment_tpu/utils/logging.py``.

* ``span`` / ``record`` / ``spans``: named spans of host time on the
  profiler's clock, kept in a bounded ring per name, also profiler
  ranges (``record_function``'s) while a profiler runs; and
  ``Counter``, a count shared by threads.
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
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._autograd import (
    _record_function_with_args_enter as _range_enter,
    _record_function_with_args_exit as _range_exit)

from ..parallel import mesh


def is_main_process() -> bool:
    return mesh.rank() == 0


class Span(NamedTuple):
    """One finished span: ``start_ns`` and ``end_ns`` on ``time.time_ns()``,
    ``parent_id`` the span that was open around it (None at the top),
    ``thread`` the ident of the thread that recorded it."""
    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: Optional[int]
    thread: int
    attrs: dict

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


RING = 65_536              # records kept per span name
_rings: Dict[str, deque] = {}
_rings_lock = threading.Lock()
_ids = itertools.count(1)


class _Local(threading.local):
    def __init__(self) -> None:
        self.stack: List["span"] = []   # this thread's open spans


_local = _Local()


def _ring(name: str) -> deque:
    ring = _rings.get(name)
    if ring is None:
        with _rings_lock:
            ring = _rings.setdefault(name, deque(maxlen=RING))
    return ring


def record(name: str, start_ns: int, end_ns: int,
           parent_id: Optional[int] = None, thread: Optional[int] = None,
           **attrs) -> int:
    """Keep a span whose ends were taken apart (on ``time.time_ns()``),
    such as one that starts on one thread and ends on another; returns its
    id."""
    span_id = next(_ids)
    _ring(name).append(Span(name, start_ns, end_ns, span_id, parent_id,
                            threading.get_ident() if thread is None
                            else thread, attrs))
    return span_id


class span:
    """A named span of host time, kept in its name's ring (:func:`spans`).

    >>> with span("train.forward", micro=0) as s:
    ...     s.attrs["rows"] = 128        # attrs may be set until it ends

    ``start_ns`` and ``end_ns`` are ``time.time_ns()``, the clock on which
    ``torch.profiler`` stamps its host events and device records, so a span
    can be laid over a profiled slice. Its parent is the innermost span
    open on the same thread. While a profiler is running the span is also
    a profiler range of its name (``torch.profiler.record_function``'s
    kind), so it shows on the profile's timeline; with none running it
    costs no profiler work.
    Always on: every ring holds the last :data:`RING` records."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "start_ns",
                 "end_ns", "_range")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "span":
        stack = _local.stack
        self.parent_id = stack[-1].span_id if stack else None
        self.span_id = next(_ids)
        stack.append(self)
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            # A range through calls that keep the GIL: ``record_function``
            # calls an operator, which releases it at both ends, and
            # taking it back from a busy thread (the server's) costs a
            # whole switch interval, milliseconds a span.
            self._range = _range_enter(self.name)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._range is not None:
            _range_exit(self._range)
        _local.stack.pop()
        _ring(self.name).append(Span(self.name, self.start_ns, self.end_ns,
                                     self.span_id, self.parent_id,
                                     threading.get_ident(), self.attrs))
        return False


def inherited(key: str, default=None):
    """``key``'s value in the innermost open span on this thread that has
    it among its attrs."""
    for s in reversed(_local.stack):
        if key in s.attrs:
            return s.attrs[key]
    return default


def spans(name: str, since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> List[Span]:
    """The kept records of ``name`` that started in ``[since_ns,
    until_ns)`` (either end open when None), oldest first."""
    ring = _rings.get(name)
    if not ring:
        return []
    return [s for s in list(ring)
            if (since_ns is None or s.start_ns >= since_ns)
            and (until_ns is None or s.start_ns < until_ns)]


def quantile(values: Iterable[float], q: float) -> Optional[float]:
    """The ``q`` quantile of ``values`` by the lower index ``q·(n − 1)``;
    None when there are none."""
    s = sorted(values)
    return s[int(q * (len(s) - 1))] if s else None


class Counter:
    """A count shared by threads, since the last :meth:`reset`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def value(self) -> int:
        return self._n


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
