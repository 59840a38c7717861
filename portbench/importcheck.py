"""Checks that the benchmark measures the PyTorch port alone.

``forbidden_loaded`` lists the loaded modules whose top-level name (the
part before the first dot, compared whole) is JAX's or the JAX package's:
``segtpu_torch`` begins with ``segtpu`` and passes. ``reference_imports``
lists the modules that ``reference/`` imports by its source, so that a
test and every run can show it imports nothing of the program.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import List, Set

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "segtpu"})
PROGRAM = "segtpu_torch"
REFERENCE = Path(__file__).resolve().parent / "reference"


def forbidden_loaded(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def reference_imports(folder: Path = REFERENCE) -> Set[str]:
    """The top-level names of every module imported in ``folder``'s
    sources."""
    found = set()
    for path in sorted(folder.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                found.update(a.name.split(".", 1)[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                found.add(node.module.split(".", 1)[0])
    return found


def report() -> List[str]:
    """The faults found (empty: none), after printing the check's line."""
    bad = forbidden_loaded()
    ref = reference_imports()
    faults = [f"loaded module {n}" for n in bad]
    faults += [f"reference/ imports {n}" for n in sorted(
        ref & (FORBIDDEN | {PROGRAM}))]
    verdict = "ok" if not faults else "FAILED: " + ", ".join(faults)
    print(f"portbench import check: {verdict} (no module of "
          f"{', '.join(sorted(FORBIDDEN))} loaded; reference/ imports "
          f"{', '.join(sorted(ref))})", flush=True)
    return faults
