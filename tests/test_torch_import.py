"""The PyTorch port stands alone: it imports neither jax nor the JAX package,
and its entry points refuse to fall back to the CPU silently."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def test_every_module_imports_with_jax_and_repro_blocked():
    names = [name for _, name in _modules()]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=120, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _banned(module: str) -> bool:
    return module in ("jax", "repro") or module.startswith(("jax.", "repro."))


@pytest.mark.parametrize(
    "path", [p for p, _ in _modules()] + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT))
)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad = [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            bad = [node.module] if node.module and node.level == 0 and _banned(node.module) else []
        else:
            continue
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_entry_points_raise_without_gpu_when_cpu_not_asked(monkeypatch):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.deploy import deploy_albert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("albert_edgebert")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deploy_albert(params, cfg)
    dep = deploy_albert(params, cfg, device="cpu")
    assert dep.device.type == "cpu"

    from repro_torch.launch import replay
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import MultiTaskRouter
    from repro_torch.serving.residency import ResidencyRouter, TaskDeployment, TaskResidencyManager

    model, tasks = build_model(cfg), {"mnli": params, "qqp": params}
    res = TaskResidencyManager([TaskDeployment(t, n_params=11e6) for t in tasks], sram_bytes=1e9)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiTaskRouter(model, params["embed"], tasks)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResidencyRouter(model, params["embed"], tasks, residency=res)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        replay.main([])
    router = ResidencyRouter(model, params["embed"], tasks, residency=res, device="cpu")
    assert {srv.device.type for srv in router.tasks.values()} == {"cpu"}
    assert MultiTaskRouter(model, params["embed"], tasks, device="cpu").device.type == "cpu"


def test_scan_covers_the_replay_slice():
    """The module scan above walks the package, so it covers this slice's
    modules too."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.serving.admission", "repro_torch.serving.residency",
            "repro_torch.serving.workload", "repro_torch.launch.replay"} <= names
