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
