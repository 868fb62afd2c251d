"""The port's layers point one way: every import in ``xmaps_tpu_torch/``,
at module level or inside a function, names its own layer or one to its
left in

    {config, calib, utils} < ops < io < parallel < models < runtime < apps

and no module outside ``apps/`` imports ``xmaps_tpu_torch.apps``.  The
modules are parsed with ``ast``, never imported.

These tests import nothing of JAX.
"""

import ast
from pathlib import Path

import pytest

PACKAGE = "xmaps_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent / PACKAGE
#: each top-level name of the package and its rank; the package's own
#: ``__init__`` ranks with the leftmost layer
RANK = {"__init__": 0, "config": 0, "calib": 0, "utils": 0, "ops": 1, "io": 2,
        "parallel": 3, "models": 4, "runtime": 5, "apps": 6}
LAYERS = ["base", "ops", "io", "parallel", "models", "runtime", "apps"]


def _module(path: Path) -> str:
    parts = path.relative_to(ROOT.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imported(tree: ast.AST, module: str, is_package: bool):
    """Every ``(line, module name)`` the tree imports, relative imports
    resolved against ``module``; ``from xmaps_tpu_torch import name``
    yields ``xmaps_tpu_torch.name``, since ``name`` is then a layer."""
    here = module.split(".") if is_package else module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                stem = here[:len(here) - node.level + 1]
                base = ".".join(stem + ([base] if base else []))
            if base != PACKAGE:
                yield node.lineno, base
            for alias in node.names if base == PACKAGE else ():
                yield node.lineno, f"{base}.{alias.name}"


def _layer(name: str):
    """The top-level name of the package a module name falls in, or None
    for a module outside the package."""
    parts = name.split(".")
    if parts[0] != PACKAGE or len(parts) < 2 or parts[1] not in RANK:
        return None
    return parts[1]


def _edges():
    """``(file, line, importer's layer, imported module, its layer)`` for
    every import of the package's own modules."""
    out = []
    for path in sorted(ROOT.rglob("*.py")):
        module = _module(path)
        src = _layer(module) or "__init__"
        tree = ast.parse(path.read_text(), str(path))
        for line, name in _imported(tree, module, path.name == "__init__.py"):
            dst = _layer(name)
            if dst is not None:
                out.append((path.relative_to(ROOT.parent), line, src, name, dst))
    return out


EDGES = _edges()


def test_every_module_has_a_layer():
    tops = {p.relative_to(ROOT).parts[0].removesuffix(".py")
            for p in ROOT.rglob("*.py")}
    assert tops <= set(RANK), sorted(tops - set(RANK))
    assert EDGES, "no import of the package found"


@pytest.mark.parametrize("layer", LAYERS)
def test_imports_point_down_the_stack(layer):
    rank = LAYERS.index(layer)
    wrong = [f"{f}:{line} imports {name}" for f, line, src, name, dst in EDGES
             if RANK[src] == rank and RANK[dst] > rank]
    assert not wrong, "\n".join(wrong)


def test_only_apps_import_apps():
    wrong = [f"{f}:{line} imports {name}" for f, line, src, name, dst in EDGES
             if dst == "apps" and src != "apps"]
    assert not wrong, "\n".join(wrong)
