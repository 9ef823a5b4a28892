"""The benchmark's files: no JAX anywhere, a reference that imports
nothing of the port, and a ``BENCHMARK.json`` that agrees with the files
it names."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from port_bench import spec

BENCH = Path(spec.__file__).resolve().parent
REPO = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "clip_finegrained_alignment_tpu"}
PORT = "clip_finegrained_alignment_tpu_torch"


def imported_roots(path: Path) -> set:
    """Top-level names of every module a file imports (whole names)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_imports():
    for path in BENCH.rglob("*.py"):
        assert not imported_roots(path) & JAX, path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        roots = imported_roots(path)
        assert PORT not in roots and not roots & JAX, path
        assert roots <= {"__future__", "math", "typing", "torch"}, path


def test_modules_load_no_jax():
    """Importing every module of the harness, and the port modules the
    drivers load, leaves no JAX module behind."""
    mods = [".".join(p.relative_to(REPO).with_suffix("").parts)
            for p in BENCH.rglob("*.py")
            if "tests" not in p.parts and "metrics" not in p.parts]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import clip_finegrained_alignment_tpu_torch.cli.serve\n"
            "import clip_finegrained_alignment_tpu_torch.train.engine\n"
            "from port_bench import harness\n"
            "print(harness.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, check=True).stdout
    assert out.strip() == "[]"


def test_jax_check_compares_whole_names(monkeypatch):
    from port_bench import harness
    monkeypatch.setitem(sys.modules, PORT + ".x", object())
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "clip_finegrained_alignment_tpu.x",
                        object())
    assert harness.jax_modules() == ["clip_finegrained_alignment_tpu"]


def test_benchmark_json_agrees_with_the_files():
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    assert b["paths"] == ["port_bench"]
    assert b["command"][:3] == ["python3", "-m", "port_bench.run"]
    for c in b["configs"]:
        assert spec.NAME.match(c["name"])
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = spec.load("configs", c["name"])
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        cell = spec.load("workloads", w["name"])
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}
        spec.cell(w["name"])
    readers = spec.metric_readers()
    assert set(readers) == {m["name"] for m in b["per_layer"]}
    for m in b["per_layer"]:
        assert readers[m["name"]][1] == m["unit"]
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert all(spec.NAME.match(n) for n in names)
