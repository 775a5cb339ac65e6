"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``repro`` (compared whole: ``repro_torch`` is the port), and
nothing of the port under ``portbench/reference``."""
import ast
import json
import subprocess
import sys

from portbench import harness
from conftest import ROOT


def imported_top_names(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not imported_top_names(path) & set(harness.FORBIDDEN), path


def test_the_references_import_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        names = imported_top_names(path)
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "math", "typing", "torch", "portbench"}, (path, names)
        src = path.read_text()
        assert "portbench.families" not in src and "portbench.harness" not in src, path


def test_names_are_compared_whole():
    sys.modules.setdefault("reproduction_notes", type(sys)("reproduction_notes"))
    assert "repro" not in harness.forbidden_modules()
    assert "repro_torch" not in harness.forbidden_modules()


def test_a_run_loads_no_forbidden_module(smoke_root, tmp_path):
    """A whole run of every cell in a fresh process (the port's server, the
    readers, the references), then every loaded module's top-level name."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import torch
torch.set_num_threads(1)
from portbench import harness, spec
for name in ("albert-serve-poisson", "albert-backlog-long", "deepseek7b-decode-ee"):
    cell = spec.load_cell(name, {str(smoke_root)!r})
    r = harness.run_cell(cell, 3, 0.5, False, "cpu")
    for m in cell.per_layer:
        harness.load_reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN), loaded & set(harness.FORBIDDEN)


def test_a_module_loaded_after_the_window_withholds_the_result(monkeypatch, capsys):
    """The look is made as the result is printed, after the reference and
    any control have run: a forbidden module loaded by then leaves no
    result line and a non-zero exit."""
    result = {"correct": True, "checks": {"unanswered": {"value": 0, "limit": 0}}}
    assert harness.print_result(result) == 0
    assert capsys.readouterr().out.strip().startswith("{")
    monkeypatch.setitem(sys.modules, "jaxlib", type(sys)("jaxlib"))
    assert harness.print_result(result) == 1
    out = capsys.readouterr()
    assert out.out == "" and "jaxlib" in out.err
