"""The port and ``chip_smoke.py`` import neither JAX nor the JAX package.

An AST scan of every import statement (including imports inside
functions), not a ``sys.modules`` check: a process may have imported JAX
for other reasons before the port is imported.
"""

import ast
from pathlib import Path

import pytest

from clip_finegrained_alignment_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "clip_finegrained_alignment_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "clip_finegrained_alignment_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if "_build" not in f.parts]


def test_sources_exist():
    files = _sources()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 10


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_kernel_build_targets_hopper_and_refuses_without_nvcc(monkeypatch):
    cmd = _build.nvcc_command("nvcc", "attention_fwd",
                              _build.library_path("attention_fwd"))
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    assert str(_build.CSRC / "attention_fwd.cu") in cmd
    assert _build.library_path("attention_fwd").parent == _build.BUILD_DIR
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "library_path",
                        lambda name: _build.BUILD_DIR / "never-built.so")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("attention_fwd")


@pytest.mark.parametrize("name", sorted(_build.SOURCES))
def test_every_kernel_source_exists_with_its_c_entry(name):
    src = _build.CSRC / _build.SOURCES[name]
    assert src.exists()
    assert f'extern "C" int cfa_{name}(' in src.read_text()
    assert _build.library_path(name).name.startswith(f"lib{name}-")


def test_first_load_starts_every_missing_build_at_once(monkeypatch, tmp_path):
    """One nvcc per source, all started before any is waited on; a failed
    build raises with its log after the others have ended."""
    events = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            self.name = next(n for n in _build.SOURCES
                             if cmd[-1].endswith(_build.SOURCES[n]))
            events.append(("start", self.name))
            self.returncode = 1 if self.name == "sparc_bwd" else 0

        def communicate(self):
            events.append(("wait", self.name))
            if self.returncode == 0:
                open(self.out, "w").close()
            return ("ptxas info: Used 64 registers", None)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    with pytest.raises(RuntimeError, match="sparc_bwd"):
        _build._build_missing()
    starts = [i for i, (kind, _) in enumerate(events) if kind == "start"]
    waits = [i for i, (kind, _) in enumerate(events) if kind == "wait"]
    assert len(starts) == len(_build.SOURCES) and max(starts) < min(waits)
    built = {n for n in _build.SOURCES if _build.library_path(n).exists()}
    assert built == set(_build.SOURCES) - {"sparc_bwd"}
    # The next attempt builds only what is missing.
    events.clear()
    with pytest.raises(RuntimeError):
        _build._build_missing()
    assert events == [("start", "sparc_bwd"), ("wait", "sparc_bwd")]


def test_a_header_edit_renames_the_libraries(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("attention_fwd.cu", "sparc_common.cuh"):
        (csrc / name).write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path("attention_fwd")
    (csrc / "sparc_common.cuh").write_text("// v2\n")
    assert _build.library_path("attention_fwd") != before
