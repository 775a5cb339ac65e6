"""The cell's description, read from ``BENCHMARK.json`` and the files it
names: ``configs/<config>.json`` and ``traffic/<traffic>.json`` under the
benchmark's folder.  Nothing here knows a cell, a configuration or a metric
by name: a later cell is new files and new entries."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

PKG = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict                 # configs/<config>.json
    traffic: Dict                # traffic/<traffic>.json
    end_to_end: List[Dict]       # the end-to-end metrics this cell reports
    per_layer: List[Dict]        # the per-layer metrics this cell reports


def _reports(metric: Dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed under the metric's
    ``workloads``, or, without that key, the cell reports what it moves (a
    per-layer metric) or every cell reports it (an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, root: Path = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its configuration
    and traffic files from ``<root>/portbench`` (``root``: the checkout)."""
    root = Path(root) if root is not None else PKG.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    folder = root / "portbench"
    config = json.loads((folder / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((folder / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                end_to_end=e2e, per_layer=per_layer)
