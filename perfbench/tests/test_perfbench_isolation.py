"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "attngan_tpu"}


def sources(root: str):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(HERE)),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(HERE,
                                                             "reference"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "attngan_torch" not in names
    assert names <= {"__future__", "contextlib", "math", "typing", "torch",
                     "perfbench"}


def test_the_match_is_by_whole_name():
    """``attngan_torch`` begins with ``attngan_t`` but is not
    ``attngan_tpu``; a prefix match would refuse the port."""
    assert "attngan_torch" not in FORBIDDEN
    assert not {"attngan_torch"} & FORBIDDEN
