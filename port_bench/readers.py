"""Helpers of the per-layer readers (``metrics/*.py``).

A reader gets ``ctx``: ``kind`` (the driver: ``train`` or ``serve``),
``trace`` (``trace.read``'s slice), ``units`` (whole steps in the slice, for
training), ``calls_per_unit`` (each kernel role's calls in one step or one
device batch, by shape), ``kernels`` (``spec.kernel_impls``) and the
driver's own counts.
"""

from __future__ import annotations

from typing import Iterable, Optional

from . import trace
from .kernels.counts import bound_seconds

ELEMENTWISE = ("elementwise", "reduce", "layer_norm")
NOT_LAUNCHES = ("memcpy", "memset")


def class_seconds(ctx: dict, classes: Iterable[str]) -> float:
    want = set(classes)
    return sum((b - a) / 1e9 for a, b, n in ctx["trace"]["records"]
               if trace.classify(n) in want)


def launches(ctx: dict) -> Optional[int]:
    n = sum(1 for _, _, name in ctx["trace"]["records"]
            if trace.classify(name) not in NOT_LAUNCHES)
    return n or None


def roofline(ctx: dict, roles: Iterable[str]) -> Optional[float]:
    """The roles' bound seconds over their kernel seconds in the slice, in
    %: each role's calls (its records over the launches a call) are split
    into units by the unit's calls, and each unit's calls are bounded by
    their shapes (``kernels/counts.py``)."""
    roles = [r for r in roles if r in ctx["kernels"]
             and ctx["calls_per_unit"].get(r)]
    seen = trace.roles_in(ctx["trace"], {r: ctx["kernels"][r] for r in roles})
    bound = secs = 0.0
    for role, got in seen.items():
        per_unit = ctx["calls_per_unit"][role]
        units = got["calls"] / len(per_unit)
        bound += units * sum(bound_seconds(role, c)[0] for c in per_unit)
        secs += got["seconds"]
    return 100.0 * bound / secs if secs > 0 else None


def idle_share(ctx: dict) -> Optional[float]:
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
