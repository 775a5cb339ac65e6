"""A cell is added as files: a traffic file and an entry in
``BENCHMARK.json``, no edit of the harness.  The throwaway cell here sends
short sentences in a closed loop to the classifier configuration."""
import json

import pytest

from portbench import harness, spec


def test_a_new_traffic_file_makes_a_new_cell(smoke_root, tmp_path):
    root = tmp_path
    (root / "portbench" / "configs").mkdir(parents=True)
    (root / "portbench" / "traffic").mkdir(parents=True)
    for f in (smoke_root / "portbench" / "configs").iterdir():
        (root / "portbench" / "configs" / f.name).write_text(f.read_text())
    (root / "portbench" / "traffic" / "albert-short-burst.json").write_text(json.dumps(
        {"kind": "closed_loop", "clients": 6, "block": 16, "ramp_s": 0.1,
         "length": {"dist": "uniform", "min": 4, "max": 14}}))
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "albert-short-burst", "config": "albert_edgebert",
                               "traffic": "albert-short-burst", "chips": 1, "why": "a throwaway cell"})
    next(m for m in bench["end_to_end"] if m["name"] == "cls_sentences_per_s")["workloads"].append("albert-short-burst")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("albert-short-burst", root)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "cls_sentences_per_s"]
    r = harness.run_cell(cell, 11, 1.0, False, "cpu")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "cls_sentences_per_s"}
    assert r["metrics"]["cls_sentences_per_s"]["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("name,stem", [("step.mfu.tput", "step.mfu"), ("device.idle_share.newcell", "device.idle_share"),
                                       ("kernels_roofline", "kernels_roofline")])
def test_a_metric_name_finds_its_reader_by_its_stem(name, stem):
    """A per-layer metric whose suffix only says which end-to-end metric it
    moves reads with the reader of its stem: a new cell's such metric is an
    entry in ``BENCHMARK.json``, no file."""
    from pathlib import Path

    read = harness.load_reader(name)
    assert Path(read.__code__.co_filename).name == f"{stem}.py"
