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


def test_decoder_entry_points_raise_without_gpu_when_cpu_not_asked(monkeypatch):
    import dataclasses

    import numpy as np

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.engine import DecoderServer, probe_exit_threshold

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), dtype="float32")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderServer(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_exit_threshold(model, params, [np.arange(4, 9)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "deepseek_7b", "--smoke"])
    assert DecoderServer(model, params, device="cpu").device.type == "cpu"

    # the MoE family through the same entry points
    cfg = dataclasses.replace(get_smoke_config("qwen2_moe_a2p7b"), dtype="float32")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderServer(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe_exit_threshold(model, params, [np.arange(4, 9)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2_moe_a2p7b", "--smoke"])
    assert DecoderServer(model, params, device="cpu").device.type == "cpu"


def test_scan_covers_the_decoder_slice():
    """The module scan walks the package, so it covers the decoder slice's
    new module too."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.configs.deepseek_7b", "repro_torch.serving.engine",
            "repro_torch.serving.step_math", "repro_torch.data.synthetic"} <= names


def test_scan_covers_the_moe_slice():
    """The module scan walks the package, so it covers the MoE slice's
    modules too."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.models.moe", "repro_torch.configs.qwen2_moe_a2p7b",
            "repro_torch.configs.qwen3_moe_235b"} <= names


def test_scan_covers_the_training_slice():
    """The module scan walks the package, so it covers the training slice's
    modules too."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.common.util", "repro_torch.core.distill", "repro_torch.core.pruning",
            "repro_torch.training.losses", "repro_torch.training.optim", "repro_torch.training.train_loop",
            "repro_torch.checkpoint.manager", "repro_torch.launch.train", "repro_torch.launch.finetune",
            "repro_torch.bridge"} <= names


def test_training_entry_points_raise_without_gpu_when_cpu_not_asked(monkeypatch, tmp_path):
    from repro_torch.launch import finetune, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune.main(["--steps", "12"])
