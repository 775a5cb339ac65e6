"""Fixtures of the benchmark's CPU tests: a benchmark root holding the
cells of ``BENCHMARK.json``, and the parked cells of ``portbench/parked/``
(entries a later ``BENCHMARK.json`` takes as they are), at a size a CPU
test run can hold (the same files, the model and the traffic cut down)."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_MODEL = {
    "albert_edgebert": dict(n_layers=4, d_model=64, n_heads=4, head_dim=16, d_ff=128, embed_dim=32,
                            vocab_size=512, max_seq_len=128),
    "deepseek_7b": dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=8, head_dim=8, d_ff=96, vocab_size=512),
}
SMOKE_SERVER = {"albert_edgebert": dict(lanes=4, buckets=[16, 32]), "deepseek_7b": dict(lanes=2, max_seq=64)}
SMOKE_CAL = {"albert_edgebert": dict(sentences=32, mean_exit_layer=3.0), "deepseek_7b": dict(sequences=2, length=16)}
SMOKE_SAMPLE = {"albert_edgebert": 1000, "deepseek_7b": 6}
SMOKE_TRAFFIC = {
    "poisson_open": {"rate_per_s": 50.0, "block": 32, "ramp_s": 0.2,
                     "length": {"dist": "lognormal", "median": 12, "sigma": 0.6, "min": 4, "max": 32}},
    "closed_loop": {"block": 8, "ramp_s": 0.2},
}


def smoke_config(name: str, model=None) -> dict:
    c = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    c["model"].update(SMOKE_MODEL[name], **(model or {}))
    c["server"].update(SMOKE_SERVER[name])
    c["calibration"].update(SMOKE_CAL[name])
    c["check"]["sample"] = SMOKE_SAMPLE[name]
    return c


def smoke_traffic(traffic: dict) -> dict:
    t = dict(traffic, **SMOKE_TRAFFIC[traffic["kind"]])
    if traffic["kind"] == "closed_loop":
        t["clients"] = 4 if "new_tokens" in traffic else 8
        hi = 8 if "new_tokens" in traffic else 32
        t["length"] = {"dist": "uniform", "min": hi // 2, "max": hi}
        if "new_tokens" in traffic:
            t["new_tokens"] = {"dist": "uniform", "min": 6, "max": 12}
    return t


def write_root(root: Path, models=None) -> Path:
    """``root`` laid out as a checkout: BENCHMARK.json and the cells'
    configuration and traffic files at smoke size (``models``: sizes that
    differ from it, by configuration)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for f in sorted((ROOT / "portbench" / "parked").glob("*.json")):
        parked = json.loads(f.read_text())
        for key in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[key] += parked[key]
    (root / "portbench" / "configs").mkdir(parents=True, exist_ok=True)
    (root / "portbench" / "traffic").mkdir(parents=True, exist_ok=True)
    for c in bench["configs"]:
        (root / "portbench" / "configs" / f"{c['name']}.json").write_text(
            json.dumps(smoke_config(c["name"], (models or {}).get(c["name"]))))
    for w in bench["workloads"]:
        t = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(smoke_traffic(t)))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    import torch

    torch.set_num_threads(1)
    return write_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def cuda():
    """The card, or a skip where none is present (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")
