"""Collection where JAX is not installed.

The card's host has the port and not the JAX reference, and runs the
port's card tests with ``python -m pytest -q -m cuda tests/``.  A test file
that imports ``jax`` or the reference package ``repro``, itself or through
another test module, cannot be imported there, so it is left out of the
collection.  Where JAX is installed every file is collected.
"""

import ast
import pathlib

HERE = pathlib.Path(__file__).parent
REFERENCE = {"jax", "jaxlib", "repro"}


def _needs_reference(name, seen=()):
    tree = ast.parse((HERE / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for top in (m.split(".")[0] for m in mods):
            if top in REFERENCE or (
                    top not in seen and (HERE / f"{top}.py").exists()
                    and _needs_reference(top, seen + (name,))):
                return True
    return False


try:
    import jax  # noqa: F401
except ImportError:
    collect_ignore = sorted(p.name for p in HERE.glob("*.py")
                            if _needs_reference(p.stem))
