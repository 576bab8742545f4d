"""Nothing under benchmark/ imports JAX or the JAX package, compared by the
whole top-level module name (`bcnf_tpu_torch` is the port and passes;
`bcnf_tpu` does not), and the reference imports nothing of the port."""

import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "bcnf_tpu"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not top_level_imports(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert not top_level_imports(path) & (FORBIDDEN | {"bcnf_tpu_torch"}), path


@pytest.mark.parametrize("folder", ["loops", "metrics"])
def test_span_targets_are_port_modules(folder):
    from benchmark.harness import load_module

    paths = sorted((BENCH / folder).glob("*.py"))
    assert paths
    for path in paths:
        for target in getattr(load_module(folder, path.stem), "SPANS", {}).values():
            assert target.split(":")[0].split(".")[0] == "bcnf_tpu_torch"


def test_the_run_refuses_by_whole_top_level_name(monkeypatch):
    from benchmark.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "bcnf_tpu_torch_extra_probe", object())
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bcnf_tpu.models", object())
    assert forbidden_modules() == ["bcnf_tpu"]
