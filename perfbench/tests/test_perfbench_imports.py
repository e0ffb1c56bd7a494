"""No JAX and no JAX package in the benchmark's process, and nothing of
the program in the reference, compared by whole top-level module names
(``repro_torch`` is not ``repro``)."""

import ast
import json
import subprocess
import sys

import pytest
from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str) -> set:
    code = PROBE.format(root=str(ROOT), src=str(ROOT / "src"),
                        imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax_and_no_jax_package():
    pytest.importorskip("torch")
    names = loaded(
        "from perfbench import harness\n"
        "from repro_torch.models import transformer\n"
        "from repro_torch.runtime import steps\n"
        "from repro_torch.kernels import flash_attention, _build\n"
        "import glob, os\n"
        "for f in sorted(glob.glob(os.path.join(harness.HERE, 'metrics', "
        "'*.py'))):\n"
        "    harness.metric_module(os.path.basename(f)[:-3])\n")
    assert "repro_torch" in names and "perfbench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    pytest.importorskip("torch")
    names = loaded("from perfbench.reference import model")
    assert not names & (FORBIDDEN | {"repro_torch"})


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_names_jax_or_the_jax_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        names = set(top_level_imports(path))
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "repro_torch" not in names, path


def test_top_level_names_are_compared_whole():
    names = {m.split(".")[0] for m in ("repro_torch.models", "jaxtyping",
                                       "flaxen.x")}
    assert not names & FORBIDDEN
    assert json.loads('["repro"]')[0] in FORBIDDEN


def test_the_run_finds_jax_loaded_in_its_process(monkeypatch):
    pytest.importorskip("torch")
    import types
    from perfbench import harness
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike",
                        types.ModuleType("repro_torch_lookalike"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jax", "repro"]
