"""segtpu_torch and chip_smoke.py stand alone: no import of jax, flax or
the JAX package segtpu, checked on the source and on a live import."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "segtpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "segtpu"}


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_nothing_of_jax(path):
    assert path.is_file()
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sources_cover_every_port_module():
    """The glob above reaches the kernel wrappers and the bench tools, so
    the two tests here check them too."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("kernels/attention_gate.py", "kernels/fused_conv.py",
                "kernels/fused_block.py", "tools/__init__.py",
                "tools/kernel_bench.py", "tools/fused_block_bench.py"):
        assert f"segtpu_torch/{mod}" in names
    assert "chip_smoke.py" in names


def test_package_imports_with_jax_blocked():
    """Every module of the port imports with jax, flax and segtpu made
    unimportable."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (ROOT / "segtpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
