"""The encoder cell (``modernbert-docs-8k``, ModernBERT-large's early-exit
classifier) at smoke size on the CPU: a whole run through the harness is
correct; every fault planted in the reference in the program's place is
not, and on the card neither is the TF32 control; its per-layer metrics
find their readers; the work counts and the span kernel's roofline reader
by hand.

The shared smoke root (``conftest.write_root``) sizes every
configuration of ``BENCHMARK.json`` from conftest's tables;
``portbench/conftest.py`` enters the encoder's sizes into them."""
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import conftest
from portbench import encoder_work, harness, peaks, spec

CELL = "modernbert-docs-8k"

METRICS = {"engine.depth_groups_per_step.doc": "engine.depth_groups_per_step",
           "span_attention.roofline.doc": "span_attention.roofline", "step.mfu.doc": "step.mfu",
           "device.idle_share.doc": "device.idle_share", "host.syncs_per_step.doc": "host.syncs_per_step",
           "exit.avg_layer.tput.doc": "exit.avg_layer.tput"}


def test_cell_runs_correct_at_smoke_size(smoke_root):
    cell = spec.load_cell(CELL, smoke_root)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "cls_sentences_per_s"]
    assert sorted(m["name"] for m in cell.per_layer) == sorted(METRICS)
    r = harness.run_cell(cell, 2 ** 31 + 91, 1.5, False, "cpu")
    assert r["correct"], r["checks"]
    assert r["readings"]["checked"] > 0 and r["readings"]["exit_rule"] == 0
    assert r["metrics"]["cls_sentences_per_s"]["value"] > 0 and r["failed"] == 0


def test_every_planted_fault_is_not_correct(smoke_root):
    """The reference with a local layer attending globally, with one lane's
    document run at the wrong layer, with a deep global layer attending in
    its window, exiting a layer late or answering a layer early, each put
    in the program's place: ``correct`` false."""
    r = harness.run_cell(spec.load_cell(CELL, smoke_root), 2 ** 31 + 92, 1.5, False, "cpu", control=True)
    assert r["correct"], r["checks"]
    assert set(r["fault_correct"]) == {"local_as_global", "wrong_layer", "global_as_local", "exit_late", "answer_before"}
    assert not any(r["fault_correct"].values()), r["fault_readings"]


@pytest.mark.cuda
def test_tf32_control_is_not_correct(cuda, tmp_path):
    """On the card, at two layers of the published width (1024) over
    documents of 512-1024 tokens: the reference in TF32 in the program's
    place fails a limit where the program's run passes them."""
    root = conftest.write_root(tmp_path, {"modernbert_large": dict(n_layers=3, d_model=1024, n_heads=16, head_dim=64,
                                                                   d_ff=2624, vocab_size=4096, max_seq_len=1024,
                                                                   local_window=128)})
    cfg = json.loads((root / "portbench" / "configs" / "modernbert_large.json").read_text())
    cfg["server"].update(lanes=4, buckets=[1024])
    (root / "portbench" / "configs" / "modernbert_large.json").write_text(json.dumps(cfg))
    t = json.loads((root / "portbench" / "traffic" / f"{CELL}.json").read_text())
    t["length"] = {"dist": "uniform", "min": 512, "max": 1024}
    (root / "portbench" / "traffic" / f"{CELL}.json").write_text(json.dumps(t))
    r = harness.run_cell(spec.load_cell(CELL, root), 2 ** 31 + 5, 3.0, False, "cuda", control=True)
    assert r["correct"], r["checks"]
    assert r["control_correct"] is False, r["control_checks"]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_each_metric_finds_its_reader(name):
    read = harness.load_reader(name)
    assert Path(read.__code__.co_filename).name == f"{METRICS[name]}.py"


M = {"d_model": 64, "d_ff": 96, "n_heads": 4, "head_dim": 16, "num_classes": 3, "global_every": 3, "local_window": 8}


@pytest.mark.parametrize("S,kv,half", [(16, 16, -1), (16, 9, -1), (16, 16, 4), (32, 20, 4), (8, 3, 4), (200, 130, 64)])
def test_visible_pairs_by_brute_force(S, kv, half):
    i, j = np.meshgrid(np.arange(S), np.arange(kv), indexing="ij")
    want = int((np.abs(i - j) <= half).sum()) if half >= 0 else S * kv
    assert encoder_work.visible_pairs(S, kv, half) == want


def test_doc_flops_by_hand():
    """Two layers of a 10-token document: layer 0 global (100 pairs), layer
    1 local with 4 positions either side (10 * 9 - 2 * (1 + 2 + 3 + 4) = 70
    pairs)."""
    d, ff = 64, 96
    lin = 2 * 10 * (4 * d * d + 3 * d * ff * 0.5)
    ramp = 2 * d * d + 2 * d * 3
    assert encoder_work.visible_pairs(10, 10, 4) == 70
    assert encoder_work.doc_flops(M, 10, 2, 0.5) == pytest.approx(2 * lin + 4 * (100 + 70) * d + 2 * ramp)


def test_span_roofline_reader_by_hand():
    """Two steps in the traced window, one outside it; each step's span
    calls priced at its lanes' layers (from the layer log, matched by
    time) over the device time of the span kernel's operations inside the
    counted steps."""
    read = harness.load_reader("span_attention.roofline.doc")
    log = [(150, np.array([0, 1, -1], np.int16)), (250, np.array([2, -1, 3], np.int16)),
           (950, np.array([0, 0, 0], np.int16))]
    steps = [{"t0": 100, "t1": 200, "bucket": 32, "lane_len": [32, 20, 5]},
             {"t0": 210, "t1": 300, "bucket": 32, "lane_len": [17, 32, 30]},
             {"t0": 900, "t1": 1000, "bucket": 32, "lane_len": [32, 32, 32]}]
    ops = [(120, 130, "span_attention_kernel<64>"), (140, 150, "layernorm_kernel"),
           (220, 260, "void span_attention_kernel<64>(Args)"), (950, 990, "span_attention_kernel<64>")]
    ctx = {"trace": {"lo_ns": 50, "hi_ns": 400, "ops": ops}, "hooks": SimpleNamespace(steps=steps),
           "cal": {"layer_log": log}, "cfg": {"model": M}}
    least = sum(peaks.roofline_s(*encoder_work.span_call(M, layer, 32, kv))
                for layer, kv in ((0, 32), (1, 20), (2, 17), (3, 30)))
    assert read(ctx) == pytest.approx(100.0 * least / 50e-9)
    assert read(dict(ctx, cal={})) is None


def test_deep_gap_reads_the_worst_layer_by_hand():
    """``deep_gap_p50_max``: per layer from the third on, the median gap of
    the documents that ran it, counted where at least ``DEEP_MIN_DOCS``
    did; the largest of those."""
    from portbench.families import encoder

    n, L = 6, 5
    ref_ent = np.zeros((n, L))
    ref_lg = np.zeros((n, L, 3))
    gaps = np.array([[0, 0, 0.01, 0.02, 0.9], [0, 0, 0.03, 0.02, 0.9], [0, 0, 0.05, 0.02, 0.9],
                     [0, 0, 0.07, 0.04, 0.0], [0, 0, 0.5, 0.04, 0.0], [0, 0, 0.5, 0.04, 0.0]])
    depth = [5, 5, 5, 4, 4, 3]      # layer 5 run by 3 documents: left out
    outs = [{"trace": list(gaps[i, :depth[i]]), "exit": depth[i], "result": np.zeros(3)} for i in range(n)]
    cands = [np.zeros(1)] * n
    r = encoder.readings(ref_lg, ref_ent, cands, outs, thr=-1.0)
    assert encoder.DEEP_MIN_DOCS == 4
    assert r["deep_gap_p50_max"] == pytest.approx(max(np.median(gaps[:, 2]), np.median(gaps[:5, 3])))
    assert r["deep_gap_p50_max"] == pytest.approx(0.06)
