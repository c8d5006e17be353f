"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEVER = {"jax", "jaxlib", "flax", "scenelib2_tpu"}


def modules():
    for root, _dirs, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported(path) -> set:
    """Every module an import statement of the file names (the level-0
    ones whole, relative ones as perfbench's own)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("perfbench" if node.level else node.module)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not {top(n) for n in imported(path)} & NEVER


@pytest.mark.parametrize("path", sorted(p for p in modules() if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_stands_alone(path):
    tops = {top(n) for n in imported(path)}
    assert "scenelib2_torch" not in tops
    assert "torch" not in tops
    # NumPy, the standard library and the reference's own modules
    own = {n for n in imported(path) if top(n) == "perfbench"}
    assert all(n.startswith("perfbench.reference") or n == "perfbench" for n in own)


def test_top_level_names_compare_whole():
    assert top("scenelib2_torch.runtime") not in NEVER
    assert top("scenelib2_tpu.runtime") in NEVER
