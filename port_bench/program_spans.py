"""The port's own spans (``clip_finegrained_alignment_tpu_torch/utils/
logging.py``: ``span``, ``spans``) in a traced slice, for the per-layer
readers of ``metrics/``.

The port stamps its spans with ``time.time_ns()``, the clock of the
profiler's host events and device records, so a span can be laid over the
device-only slice (``trace.read``). Its extent is that of its device
records: training takes the ``train.step`` spans that overlap it (the
traced steps; the window's last step ends before the synchronize that
precedes the profiler, the host-op slice's step starts after it stops),
serving the spans that start inside it. Every helper gives None, and no
error, where there is nothing to read: a port that keeps no spans, a
slice with no device records (a CPU run), or a count of steps other than
the slice's.
"""

from __future__ import annotations

import math
import statistics
from typing import Callable, Iterable, List, Optional, Tuple


def _reader() -> Optional[Callable]:
    try:
        from clip_finegrained_alignment_tpu_torch.utils import logging
    except ImportError:
        return None
    return getattr(logging, "spans", None)


def extent(ctx: dict) -> Optional[Tuple[int, int]]:
    """The first device record's start and the last one's end."""
    busy = (ctx.get("trace") or {}).get("busy") or []
    return (busy[0][0], busy[-1][1]) if busy else None


def named(name: str) -> list:
    """Every kept span of ``name`` (none where the port keeps none)."""
    read = _reader()
    return read(name) if read is not None else []


def steps(ctx: dict) -> Optional[list]:
    """The slice's ``train.step`` spans; None unless they number
    ``ctx["units"]``."""
    if ctx.get("kind") != "train" or not ctx.get("units"):
        return None
    ext = extent(ctx)
    if ext is None:
        return None
    got = [s for s in named("train.step")
           if s.start_ns < ext[1] and s.end_ns > ext[0]]
    return got if len(got) == ctx["units"] else None


def phase(ctx: dict, name: str) -> Optional[list]:
    """The ``name`` spans directly inside the slice's steps."""
    st = steps(ctx)
    if st is None:
        return None
    ids = {s.span_id for s in st}
    return [s for s in named(name) if s.parent_id in ids]


def host_ms_per_step(ctx: dict, name: str) -> Optional[float]:
    """The ``name`` spans' host ms in the slice's steps, a step."""
    got = phase(ctx, name)
    if not got:
        return None
    return sum(s.ms for s in got) / ctx["units"]


def idle_ns(busy: List[Tuple[int, int]], a: int, b: int) -> int:
    """The nanoseconds of ``[a, b)`` that no busy interval covers
    (``busy``: sorted and disjoint, ``trace.union``'s)."""
    covered = sum(max(0, min(e, b) - max(s, a)) for s, e in busy
                  if s < b and e > a)
    return (b - a) - covered


def in_slice(ctx: dict, name: str) -> Optional[list]:
    """The serving slice's ``name`` spans: those that start inside it."""
    if ctx.get("kind") != "serve":
        return None
    ext = extent(ctx)
    if ext is None:
        return None
    got = [s for s in named(name) if ext[0] <= s.start_ns < ext[1]]
    return got or None


def p(values: Iterable[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (``drivers/serve.py::p``'s)."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def median(values: Iterable[float]) -> float:
    return statistics.median(values)
