"""The traced slices: ``torch.profiler`` on the card, read live from its
raw records (no Chrome trace is written).

A traced run profiles two slices. The first records the device alone, so
that the profiler barely slows the host: :func:`read` gives its device
records (kernels, copies, memsets; GPU-timeline annotations that repeat a
CPU op's name are left out, as the port's ``perf/trace_read.py::device_rows``
leaves them out), the busy time (their union) and the slice's length; the
per-layer readers and :func:`device_ops` read it. The second, shorter, also
records the host's ops, wrapped in ``record_function(SLICE)``:
:func:`idle_gaps` names the longest idle gaps by the innermost host op
running where each starts.

:func:`classify` is a frozen copy of the port's
``perf/trace_report.py::classify``.
"""

from __future__ import annotations

import bisect
import collections
import re
from typing import Dict, List, Optional, Tuple

SLICE = "port_bench.slice"

PORT_KERNEL = re.compile(
    r"::((?:attention|sparc|flash)_\w+|(?:absmax_rows|quant_rows|col_absmax"
    r"|reduce_partials|quant_cols_t|dequant)_kernel)\b")


def stem(name: str) -> str:
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s.strip())
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip() or name


def classify(name: str) -> str:
    """The class of one device record's name: a port kernel's own name,
    ``gemm``, ``elementwise``, ``reduce``, ``layer_norm``, ``softmax``,
    ``multi_tensor_apply``, ``memcpy``, ``memset``, or the kernel's stem."""
    m = PORT_KERNEL.search(name)
    if m:
        return m.group(1)
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    if "multi_tensor_apply" in low or "foreach" in low:
        return "multi_tensor_apply"
    if any(w in low for w in ("gemm", "cutlass", "nvjet", "xmma", "cublas",
                              "gemv")):
        return "gemm"
    if "layer_norm" in low or "layernorm" in low or "gammabeta" in low:
        return "layer_norm"
    if "softmax" in low:
        return "softmax"
    if "reduce_kernel" in low:
        return "reduce"
    if "elementwise" in low:
        return "elementwise"
    return stem(name)


def profile(cpu: bool = False):
    """A started ``torch.profiler.profile`` of the card's activity, and with
    ``cpu`` of the host's ops too (every thread where this PyTorch allows
    it). Without ``cpu`` the profiler adds little to the host's time, so the
    slice's idle share stays near the untraced run's."""
    import torch
    from torch.profiler import ProfilerActivity
    if not cpu:
        prof = torch.profiler.profile(activities=[
            ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU])
    else:
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            from torch._C._profiler import _ExperimentalConfig
            prof = torch.profiler.profile(
                activities=acts, experimental_config=_ExperimentalConfig(
                    profile_all_threads=True))
        except (ImportError, TypeError):
            prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _events(prof):
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    cpu = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == DeviceType.CPU]
    names = {n for _, _, n in cpu}
    dev = [(e.start_ns(), e.end_ns(), e.name()) for e in events
           if e.device_type() == DeviceType.CUDA and e.name() not in names
           and e.end_ns() > e.start_ns()]
    return cpu, dev


def read(prof, window_s: Optional[float] = None) -> dict:
    """A stopped device-only profile's slice: its device records, their
    union (``busy``, ``busy_s``) and ``window_s``, the host clock's length
    of the slice where the caller bracketed it with synchronizes, else the
    extent of the records."""
    _, records = _events(prof)
    busy = union([(a, b) for a, b, _ in records])
    t0 = busy[0][0] if busy else 0
    t1 = busy[-1][1] if busy else 0
    return {"records": records, "busy": busy,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": window_s if window_s is not None else (t1 - t0) / 1e9}


def idle_gaps(prof, top: int = 10, named: int = 200) -> List[list]:
    """From a stopped host-and-device profile whose slice is wrapped in
    ``record_function(SLICE)``: the longest idle gaps' seconds in the slice,
    summed by the innermost host op running where each starts (``host
    idle`` where none runs)."""
    cpu, records = _events(prof)
    spans = [(a, b) for a, b, n in cpu if n == SLICE]
    if not spans:
        return []
    t0, t1 = spans[0]
    busy = union([(max(a, t0), min(b, t1)) for a, b, _ in records
                  if min(b, t1) > max(a, t0)])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:named]
    ops = sorted(c for c in cpu if c[2] != SLICE)
    starts = [c[0] for c in ops]
    by_host: Dict[str, float] = collections.Counter()
    for length, g0 in gaps:
        name = "host idle"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(-1, i - 5000), -1):
            if ops[j][1] > g0:
                name = ops[j][2]
                break
        by_host[name] += length / 1e9
    return [[k, v] for k, v in by_host.most_common(top)]


def device_ops(tr: dict, top: int = 10) -> List[list]:
    """The device classes that took most seconds in the slice."""
    by_class: Dict[str, float] = collections.Counter()
    for a, b, n in tr["records"]:
        by_class[classify(n)] += (b - a) / 1e9
    return [[k, v] for k, v in by_class.most_common(top)]


def roles_in(tr: dict, impls: Dict[str, List[dict]]) -> Dict[str, dict]:
    """Per kernel role: the calls its implementations made in the slice
    (records over launches a call) and their summed kernel seconds."""
    out = {}
    for role, impl_list in impls.items():
        calls, secs = 0.0, 0.0
        for impl in impl_list:
            n = 0
            for a, b, name in tr["records"]:
                if impl["match"].search(name):
                    n += 1
                    secs += (b - a) / 1e9
            calls += n / impl["launches_per_call"]
        if calls:
            out[role] = {"calls": calls, "seconds": secs}
    return out
