"""What the benchmark may import: no module under benchmark/ (tests but this
guard's own neighbours included) imports jax, jaxlib, flax or the JAX
package, top-level names compared whole (the port's name begins with the
JAX package's); nothing under benchmark/reference/ imports the port or the
harness; and a run refuses to print a result once any of them is loaded."""
import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "lss2_multimodal_nu_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not set(_imports(path)) & {"lss2_multimodal_nu_tpu_torch", "benchlib"}
    assert "lss2_multimodal_nu_tpu_torch" not in path.read_text()


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    import run

    monkeypatch.setitem(sys.modules, "lss2_multimodal_nu_tpu_torch_like", object())
    assert "lss2_multimodal_nu_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert run.forbidden_modules() == ["flax"]
