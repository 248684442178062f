"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference and the generator import nothing of the
port."""

import ast
import os
import sys
import types

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "smcpp_tpu"}


def imported(path):
    "Top-level names of every module a file imports."
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(list(sources("reference")) + list(sources("gen"))),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_and_generator_stand_alone(path):
    assert "smcpp_tpu_torch" not in imported(path)


def test_names_compared_whole(monkeypatch):
    from portbench import harness

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "smcpp_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "smcpp_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["smcpp_tpu"]
