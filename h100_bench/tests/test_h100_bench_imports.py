"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``sgnn_tpu_torch`` is not ``sgnn_tpu``), and the
plain reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "sgnn_tpu"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def test_every_module_is_walked():
    names = {p.relative_to(BENCH).as_posix() for p in _modules()}
    assert {"run.py", "runners/train.py", "runners/rollout.py", "reference/common.py",
            "metrics/mfu.train.py"} <= names


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "sgnn_tpu_torch" not in set(_top_level_imports(path))


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    from h100_bench import harness

    monkeypatch.setitem(sys.modules, "sgnn_tpu_torch_like", types.ModuleType("sgnn_tpu_torch_like"))
    assert not [m for m in harness.forbidden_loaded() if m.startswith("sgnn_tpu_torch")]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert "jax.numpy" in harness.forbidden_loaded()
