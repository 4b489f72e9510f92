"""The port stands alone: no module of devo_tpu_torch, and not chip_smoke.py,
imports jax (or a library built on it) or the JAX package devo_tpu. The
machine with the GPU has no jax.

An AST walk over the sources, not a subprocess import: the interpreter of
the test environment may import jax at start-up on its own.
"""
import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "devo_tpu")
SOURCES = sorted((ROOT / "devo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_names_are_caught():
    tree = ast.parse("import jax.numpy as jnp\nfrom devo_tpu.lie import se3\n"
                     "from devo_tpu_torch.lie import se3\nimport flax\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "jax.numpy", "devo_tpu.lie", "flax"]


def test_every_port_module_imports_on_cpu():
    """Importing a module builds no kernel and needs no CUDA."""
    for path in SOURCES[:-1]:
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
