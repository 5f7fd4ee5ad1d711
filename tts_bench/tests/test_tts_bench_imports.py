"""No module of the benchmark imports JAX or the JAX package, the reference imports
nothing of the served program, and nothing reads the repository's older bench
scripts. Top-level module names are compared whole: gonova_tts_tpu_torch begins
with gonova_tts_tpu and is not it."""

from __future__ import annotations

import ast
import os

import pytest

from tts_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "gonova_tts_tpu"}
OLD_SCRIPTS = ("bench.py", "bench_suite.py", "chip_smoke.py")


def top_level_imports(source: str) -> set:
    """The top-level name (before the first dot) of every absolute import."""
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                names.add(node.args[0].value.split(".")[0])
    return names


def sources(sub: str = ""):
    root = os.path.join(spec.HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_whole_names_are_compared():
    assert top_level_imports("import gonova_tts_tpu_torch.engine\nfrom gonova_tts_tpu_torch import x") == {"gonova_tts_tpu_torch"}
    assert top_level_imports("from gonova_tts_tpu.text import y") & FORBIDDEN == {"gonova_tts_tpu"}
    assert top_level_imports("import jax.numpy as jnp") & FORBIDDEN == {"jax"}
    assert top_level_imports("importlib.import_module('flax.linen')") & FORBIDDEN == {"flax"}


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not top_level_imports(open(path).read()) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "gonova_tts_tpu_torch" not in top_level_imports(open(path).read())
    assert all(n in ("numpy", "torch", "scipy", "__future__", "io", "json", "math", "os", "re", "threading",
                     "typing", "wave") for n in top_level_imports(open(path).read()))


@pytest.mark.parametrize("path", sorted(p for p in sources() if "/tests/" not in p), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_old_bench_scripts_are_not_read(path):
    text = open(path).read()
    assert not any(name in text for name in OLD_SCRIPTS)
