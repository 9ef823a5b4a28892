"""The benchmark's data, found by name.

* ``configs/<config>.json``: a model configuration, HF ``config.json`` keys;
* ``traffic/<traffic>.json``: a traffic mix: its ``driver`` (``train`` or
  ``serve``) and the parameters that driver reads;
* ``workloads/<cell>.json``: a cell: its ``config``, ``traffic``, ``chips``,
  ``why`` and the ``limits`` of the comparisons that decide ``correct``;
* ``metrics/<metric>.py``: one per-layer metric, ``read(ctx)`` returning a
  number or None;
* ``kernels/<role>.<impl>.json``: the kernel-name patterns of one
  implementation of a kernel role (``kernels/counts.py`` counts the role's
  work from shapes).

``PORT_BENCH_ROOT`` (tests only) points the lookups at another copy of this
folder.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def root() -> Path:
    return Path(os.environ.get("PORT_BENCH_ROOT", HERE))


def _named(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = root() / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    return path


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` with its ``name``."""
    with open(_named(kind, name, ".json")) as f:
        return {**json.load(f), "name": name}


def cell(name: str) -> dict:
    """A cell with its configuration and traffic resolved."""
    c = load("workloads", name)
    c["config"] = load("configs", c["config"])
    c["traffic"] = load("traffic", c["traffic"])
    return c


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + re.sub(r"\W", "_", path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers() -> Dict[str, Tuple[Callable[[dict], Optional[float]],
                                        str]]:
    """Every ``metrics/<metric>.py``'s ``read`` and ``UNIT``, by metric
    name."""
    out = {}
    for p in sorted((root() / "metrics").glob("*.py")):
        mod = _module(p)
        out[p.stem] = (mod.read, mod.UNIT)
    return out


def kernel_impls() -> Dict[str, List[dict]]:
    """Every ``kernels/<role>.<impl>.json``, grouped by role."""
    out: Dict[str, List[dict]] = {}
    for p in sorted((root() / "kernels").glob("*.json")):
        with open(p) as f:
            impl = json.load(f)
        role = p.name.split(".")[0]
        out.setdefault(role, []).append(
            {**impl, "impl": p.name[len(role) + 1:-len(".json")],
             "match": re.compile("|".join(impl["patterns"]))})
    return out
