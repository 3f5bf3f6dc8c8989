"""Nothing under ``bench/`` imports JAX or the JAX package (top-level
names compared whole: ``repro_torch`` begins with ``repro``) or reads the
JAX package's folders, and the reference imports nothing of the port."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_bench_import_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.train\nfrom jax import numpy\n"
                 "import importlib\nimportlib.import_module('repro.core')\n")
    assert top_level_imports(f) == {"repro_torch", "jax", "importlib",
                                    "repro"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_bench_module_imports_no_jax(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN, names & FORBIDDEN
    text = path.read_text()
    if "tests" not in path.parts:
        assert "src/repro/" not in text and "benchmarks/" not in text
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names
