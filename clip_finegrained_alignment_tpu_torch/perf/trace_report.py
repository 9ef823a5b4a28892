"""Device time by kernel class: the port of ``perf/trace_report.py``.

JAX's report groups the XLA ops of a TPU trace by fusion name. Here a
class is what launched on the card:

* the port's own kernels (``csrc/*.cu``), each under its name
  (``attention_fwd_mma``, ``sparc_bwd_rows_kernel``, ``quant_rows_kernel``,
  …; :data:`PORT_KERNEL`, the names ``chip_smoke.py``'s kernel tables
  find);
* ``gemm``: cuBLAS, cuBLASLt and CUTLASS products (and cuDNN's implicit
  GEMM convolutions);
* ``elementwise``, ``reduce``, ``layer_norm``, ``softmax``;
* ``multi_tensor_apply``: the optimizers' foreach kernels;
* ``memcpy`` and ``memset``;
* anything else under its own demangled stem (``indexSelectLargeIndex``,
  ``CatArrayBatchedCopy``, …).

Two sources of rows ``(µs, name, records)``: a finished
``torch.profiler.profile`` (``perf/trace_read.py::device_rows``, one
loop over its raw records), or a Chrome trace file
(``utils/logging.py::trace_capture``'s ``trace.json``; its ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events). :func:`class_table` sums them
by class over a window of ``steps`` steps, and :func:`format_table`
prints JAX's table (ms/step, launches/step, class)::

    python -m clip_finegrained_alignment_tpu_torch.perf.trace_report \\
        TRACE.json [--steps N]

It reads a file only, as JAX's does: ``perf/profile_step.py`` traces a
window live and prints this table of it.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import re
from typing import Dict, Iterable, List, Optional, Tuple

Row = Tuple[float, str, int]

PORT_KERNEL = re.compile(
    r"::((?:attention|sparc|flash)_\w+|(?:absmax_rows|quant_rows|col_absmax"
    r"|reduce_partials|quant_cols_t|dequant)_kernel)\b")
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def stem(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    and parameters: ``void at::native::(anonymous namespace)::foo<int>(…)``
    → ``foo``."""
    s = name.replace("(anonymous namespace)::", "")
    s = re.sub(r"^void\s+", "", s.strip())
    s = re.split(r"[<(]", s, maxsplit=1)[0]
    return s.split("::")[-1].strip() or name


def classify(name: str) -> str:
    """The class of one device record's name (module docstring)."""
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


def chrome_rows(path: str) -> List[Row]:
    """(µs, name, records) of each kernel, memcpy and memset name in a
    Chrome trace file (``.json`` or ``.json.gz``), largest first."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    by_name: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        acc = by_name.setdefault(e.get("name", "?"), [0.0, 0])
        acc[0] += float(e.get("dur", 0.0))
        acc[1] += 1
    rows = [(us, k, int(n)) for k, (us, n) in by_name.items() if us > 0]
    rows.sort(reverse=True)
    return rows


def class_table(rows: Iterable[Row], steps: int = 1) -> dict:
    """The rows summed by :func:`classify` over a window of ``steps``
    steps: the device ms a step, and each class's ms and launches a step,
    largest first."""
    us_by, n_by = collections.Counter(), collections.Counter()
    for us, name, n in rows:
        c = classify(name)
        us_by[c] += us
        n_by[c] += n
    total = sum(us_by.values())
    return {"steps": steps, "device_ms_per_step": total / 1e3 / steps,
            "launches_per_step": sum(n_by.values()) // steps,
            "classes": [{"class": c, "ms_per_step": us / 1e3 / steps,
                         "launches_per_step": n_by[c] // steps,
                         "share": us / total if total else None}
                        for c, us in us_by.most_common()]}


def format_table(table: dict, top: int = 25) -> str:
    """JAX's table: the total, then ms/step, launches/step and class."""
    lines = [f"total device time: {table['device_ms_per_step']:.3f} "
             f"ms/step ({table['steps']} steps)",
             f"{'ms/step':>9}  {'launches/step':>13}  class"]
    for r in table["classes"][:top]:
        lines.append(f"{r['ms_per_step']:9.3f}  {r['launches_per_step']:13d}"
                     f"  {r['class']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="a Chrome trace file (.json or .json.gz)")
    ap.add_argument("--steps", type=int, default=2,
                    help="steps in the window (profile_step's default: 2)")
    args = ap.parse_args(argv)
    table = class_table(chrome_rows(args.trace), args.steps)
    table.update(source=args.trace)
    print(format_table(table), flush=True)
    print(json.dumps(table), flush=True)
    return table


if __name__ == "__main__":
    main()
