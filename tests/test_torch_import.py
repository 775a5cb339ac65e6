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

    # lane-sharded serving: both servers with replicas, and its launcher
    import dataclasses

    from repro_torch.launch import serve_sharded
    from repro_torch.serving.engine import ClassifierServer, DecoderServer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierServer(model, params, replicas=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClassifierServer(model, params, devices=["cuda:0", "cuda:0"], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_sharded.main([])
    assert [d.type for d in ClassifierServer(model, params, replicas=2, device="cpu").devices] == ["cpu"] * 2
    dcfg = dataclasses.replace(get_smoke_config("deepseek_7b"), dtype="float32")
    dparams = init_params(dcfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderServer(build_model(dcfg), dparams, replicas=2)
    assert DecoderServer(build_model(dcfg), dparams, replicas=2, device="cpu").lanes == 8


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

    # the ssm family (RWKV6) and the LayerNorm decoder through the same entry points
    for arch in ("rwkv6_7b", "minitron_8b"):
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = build_model(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg)
        params = init_params(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DecoderServer(model, params)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            model.init_cache(1, 8)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--smoke"])
        assert DecoderServer(model, params, device="cpu").device.type == "cpu"

    # the hybrid family (zamba2) through the same entry points, and the
    # encdec family (whisper) through the model's
    cfg = dataclasses.replace(get_smoke_config("zamba2_1p2b"), dtype="float32")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderServer(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "zamba2_1p2b", "--smoke"])
    assert DecoderServer(model, params, device="cpu").device.type == "cpu"
    cfg = dataclasses.replace(get_smoke_config("whisper_medium"), dtype="float32")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    assert model.init_cache(1, 8, device="cpu")["enc_k"].device.type == "cpu"


def test_scan_covers_the_hybrid_slice():
    """The module scan walks the package, so it covers the hybrid and
    encdec slice's modules too: Mamba2 and the two new configs."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.models.mamba2", "repro_torch.configs.zamba2_1p2b",
            "repro_torch.configs.whisper_medium"} <= names


def test_scan_covers_the_vlm_slice():
    """The module scan walks the package, so it covers this slice's new
    config, and the modules the slice changed: the model (the vlm family
    and every decoder's training forward), the server and its launcher, the
    training launcher."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.configs.llama3_2_vision_90b", "repro_torch.models.model", "repro_torch.models.mamba2",
            "repro_torch.serving.engine", "repro_torch.launch.serve", "repro_torch.launch.train"} <= names


def test_vlm_and_decoder_training_entry_points_raise_without_gpu(monkeypatch, tmp_path):
    import dataclasses

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve, train
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.engine import DecoderServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(get_smoke_config("llama3_2_vision_90b"), dtype="float32")
    model = build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecoderServer(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 8)
    for arch in ("llama3_2_vision_90b", "whisper_medium"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve.main(["--arch", arch, "--smoke"])
    assert DecoderServer(model, params, device="cpu").device.type == "cpu"
    assert model.init_cache(1, 8, device="cpu")["img_k"].device.type == "cpu"
    for arch in ("zamba2_1p2b", "deepseek_7b"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train.main(["--arch", arch, "--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_scan_covers_the_sharded_slice():
    """The module scan walks the package, so it covers the lane-sharded
    slice's new launcher and the modules it changed: the servers, their
    step math, the admission layer and the kernel lists."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.launch.serve_sharded", "repro_torch.serving.engine", "repro_torch.serving.step_math",
            "repro_torch.serving.admission", "repro_torch.kernels.ops"} <= names


def test_scan_covers_the_edgebert_decoder_slice():
    """The module scan walks the package, so it covers every module the
    slice of EdgeBERT's features on the decoder families changed: the
    model and its layers, the serving prefill and server, the kernel
    lists; chip_smoke.py (its eb_decode phase) is scanned beside them."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.models.model", "repro_torch.models.layers", "repro_torch.serving.step_math",
            "repro_torch.serving.engine", "repro_torch.kernels.ops"} <= names
    assert "def run_eb_decode_path" in (ROOT / "chip_smoke.py").read_text()


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


def test_scan_covers_the_ssm_slice():
    """The module scan walks the package, so it covers the ssm slice's
    modules too: RWKV6 and the four new configs."""
    names = {name for _, name in _modules()}
    assert {"repro_torch.models.rwkv6", "repro_torch.configs.rwkv6_7b", "repro_torch.configs.minitron_8b",
            "repro_torch.configs.internlm2_20b", "repro_torch.configs.qwen1_5_110b"} <= names


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


def test_scan_covers_the_distributed_training_slice():
    """The training half of sharding imports with jax and repro blocked: the
    mesh, the rules and ZeRO-1, the compressed all-reduce, the pipeline and
    the expert-parallel MoE (the package scan covers them too)."""
    slice_modules = ["repro_torch.launch.mesh", "repro_torch.sharding", "repro_torch.sharding.rules",
                     "repro_torch.sharding.zero1", "repro_torch.training.compress",
                     "repro_torch.training.pipeline", "repro_torch.models.moe"]
    assert set(slice_modules) <= {name for _, name in _modules()}
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {slice_modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.models.moe import apply_moe_shardmap, shard_experts\n"
        "from repro_torch.sharding.rules import distribute, placements_of\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert "def run_dist_train_path" in (ROOT / "chip_smoke.py").read_text()


def test_scan_covers_the_last_modules():
    """The last modules (the roofline with its H100 spec, the op analysis,
    the dry run and its DTensor forms, the batch specs and the pipeline's
    gradient) import with
    jax and repro blocked, and the dry run runs its hardware-free half
    there; chip_smoke drives the dry run and the pipeline's backward."""
    slice_modules = ["repro_torch.hwmodel.roofline", "repro_torch.hwmodel.op_analysis",
                     "repro_torch.launch.dryrun", "repro_torch.sharding.dtensor_forms",
                     "repro_torch.training.pipeline", "repro_torch.data.synthetic"]
    assert set(slice_modules) <= {name for _, name in _modules()}
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import importlib\n"
        f"for name in {slice_modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.hwmodel.roofline import H100_SXM, collective_bytes, roofline_report\n"
        "from repro_torch.hwmodel.op_analysis import OpAnalysis, analyze, local_mem_tracker\n"
        "from repro_torch.launch.dryrun import build_cell, run_cell, per_device_bytes, VARIANT_FLAGS\n"
        "from repro_torch.data.synthetic import make_batch_specs\n"
        "from repro_torch.sharding.dtensor_forms import installed\n"
        "from repro_torch.training.pipeline import _RingShift, _LastStageBroadcast, _ReplicatedInput\n"
        "from repro_torch.configs.base import get_config, SHAPES_BY_NAME\n"
        "from repro_torch.launch.mesh import make_production_mesh\n"
        "b = per_device_bytes(get_config('deepseek_7b'), SHAPES_BY_NAME['decode_32k'], make_production_mesh())\n"
        "assert b['params'] > 0 and b['cache'] > 0, b\n"
        "assert 'jax' not in [m.split('.')[0] for m in sys.modules if sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                          timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "def lm_train_dryrun" in smoke and "ops.DRYRUN_KERNELS" in smoke and "def dist_pipeline" in smoke


def test_dryrun_needs_no_card(monkeypatch):
    """The dry run is the one entry point that runs without a GPU by
    design: its trace is on meta and fake tensors."""
    from repro_torch.configs.base import ShapeConfig, get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = dryrun.record_cell(get_smoke_config("deepseek_7b"), ShapeConfig("d", 32, 4, "decode"),
                             Mesh(("data", "model"), (1, 1)))
    assert rec["status"] == "ok" and rec["op_analysis"]["flops_per_device"] > 0
