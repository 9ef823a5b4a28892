"""What every driver shares: the card check, the per-layer readers, the
comparisons' report and the result line.

A driver's ``run`` returns a :class:`Outcome`; :func:`finish` checks that no
JAX module was loaded, prints each compared number beside its limit on
standard error, and prints the result as the last line of standard
output, with the compared numbers under ``checks``, the last key.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "clip_finegrained_alignment_tpu")


class Refused(SystemExit):
    """Ends a run with no result: the message on standard error, exit 2."""

    def __init__(self, message: str):
        print(f"port_bench: {message}", file=sys.stderr, flush=True)
        super().__init__(2)


def device(chips: int, name: Optional[str]):
    """The card a cell runs on; without enough cards the run ends with no
    result. ``name`` (tests only) takes another device."""
    import torch
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise Refused("no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards, "
                      f"{torch.cuda.device_count()} found")
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


def build_kernels(dev) -> float:
    """Seconds spent building the port's kernel libraries that are not
    built yet (``ops/_build.py``, into its package's ``_build/`` inside the
    checkout): the first run of a checkout builds them all, every later run
    finds them and reads 0."""
    if dev.type != "cuda":
        return 0.0
    from clip_finegrained_alignment_tpu_torch.ops import _build
    missing = [n for n in _build.SOURCES if not _build.library_path(n).exists()]
    t = time.time()
    if missing:
        _build.load(missing[0])
    return time.time() - t


def jax_modules() -> list:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: the port's own name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def synchronize(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def device_fields(dev, chips: int) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def per_layer(ctx: dict) -> Dict[str, dict]:
    """Every reader's number for this slice; a reader that finds nothing
    returns None and its metric is left out."""
    out = {}
    for name, (read, unit) in spec.metric_readers().items():
        value = read(ctx)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, dict]
    device: dict
    checks: Dict[str, dict]           # name -> {"value": x, "limit": y}
    breakdown: Optional[dict] = None
    notes: Dict[str, object] = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in self.checks.values())


def check(value: Optional[float], limit: float) -> dict:
    return {"value": value, "limit": limit}


def finish(out: Outcome) -> dict:
    """Refuse a run that loaded JAX; else report and print the line."""
    found = jax_modules()
    if found:
        raise Refused(f"JAX modules loaded in the benchmark process: {found}")
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = out.checks
    for k, v in out.notes.items():
        print(f"port_bench: {k} {v}", file=sys.stderr)
    for name, c in out.checks.items():
        print(f"port_bench: {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"port_bench: correct {out.correct}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return line
