"""Import isolation of the benchmark, by top-level module name compared
whole: nothing under benchmark/ imports jax, jaxlib, flax or the JAX
package (yololp_tpu); the reference (benchmark/reference/) imports nothing
of the program (yololp_tpu_torch) either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "yololp_tpu"}
PROGRAM = {"yololp_tpu_torch"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def refused(source: str, reference: bool) -> set:
    banned = JAX_SIDE | (PROGRAM if reference else set())
    return top_level_imports(source) & banned


def sources(sub=None):
    base = BENCH / sub if sub else BENCH
    return sorted(p for p in base.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_harness_imports_no_jax_side_module(path):
    reference = "reference" in path.relative_to(BENCH).parts
    assert not refused(path.read_text(), reference), path


@pytest.mark.parametrize("src,reference,bad", [
    ("import jax.numpy as jnp", False, {"jax"}),
    ("from jaxlib import xla_client", False, {"jaxlib"}),
    ("import flax", False, {"flax"}),
    ("from yololp_tpu.core import inferer", False, {"yololp_tpu"}),
    ("import importlib\nimportlib.import_module('yololp_tpu.models')", False, {"yololp_tpu"}),
    ("from yololp_tpu_torch.ops import nms", False, set()),
    ("from yololp_tpu_torch.ops import nms", True, {"yololp_tpu_torch"}),
    ("import yololp_tpu_torchvision", True, set()),
    ("import torch", True, set()),
])
def test_the_check_compares_top_level_names_whole(src, reference, bad):
    assert refused(src, reference) == bad


def test_reference_sources_exist():
    assert sources("reference")
