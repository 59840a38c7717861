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
    """The glob above reaches the kernel wrappers, the bench tools, the
    training path, the data layer, the pretrained-encoder converter, the
    K-fold harness, the drivers and the CLI, so the tests here check them
    too."""
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for mod in ("kernels/attention_gate.py", "kernels/fused_conv.py",
                "kernels/fused_block.py", "tools/__init__.py",
                "tools/kernel_bench.py", "tools/fused_block_bench.py",
                "train/engine.py", "train/loop.py", "losses/registry.py",
                "api.py", "data/discovery.py", "data/io.py",
                "data/native.py", "data/augment.py", "data/preprocess.py",
                "data/loader.py", "ops/resize.py", "models/torch_convert.py",
                "core/config.py", "eval/folds.py",
                "eval/cross_validation.py", "experiments/common.py",
                "experiments/model_configuration.py",
                "experiments/loss_comparison.py",
                "experiments/augmentation_amount.py", "cli.py"):
        assert f"segtpu_torch/{mod}" in names
    assert "chip_smoke.py" in names


def _module_level_roots(path: Path):
    """The roots imported by the module's own body, outside any function
    or class."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_no_sklearn_and_matplotlib_only_inside_functions(
        path):
    """The card's machine has neither package: scikit-learn is imported
    nowhere, matplotlib only inside the plotting functions."""
    assert "sklearn" not in set(_imported_roots(path))
    assert "matplotlib" not in set(_module_level_roots(path))


def test_package_imports_with_jax_blocked():
    """Every module of the port imports with jax, flax, segtpu,
    scikit-learn and matplotlib made unimportable."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in (ROOT / "segtpu_torch").rglob("*.py"))
    blocked = sorted(FORBIDDEN | {"sklearn", "matplotlib"})
    code = ("import importlib, sys\n"
            f"for m in {blocked!r}: sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
