"""What the benchmark may not load: JAX and the JAX package the port was
made from.  Names are compared whole by their top-level part (the part
before the first dot), so ``repro_torch`` is not taken for ``repro``."""
from __future__ import annotations

import ast
import pathlib
import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the references may not read the program either
REFERENCE_FORBIDDEN = FORBIDDEN + ("repro_torch",)


def top_level(names: Iterable[str]) -> set:
    return {n.split(".")[0] for n in names}


def loaded(modules=None) -> List[str]:
    """The forbidden top-level modules that are loaded."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & set(FORBIDDEN))


def imports_of(path: pathlib.Path) -> set:
    """Top-level names that a source file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= top_level(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out |= top_level([node.module])
    return out


def reference_violations(root: pathlib.Path) -> List[str]:
    """``file: module`` for each forbidden import in servebench/reference."""
    out = []
    for path in sorted((root / "servebench" / "reference").glob("*.py")):
        for name in sorted(imports_of(path) & set(REFERENCE_FORBIDDEN)):
            out.append(f"{path.name}: {name}")
    return out
