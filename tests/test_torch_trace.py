"""The serving loop's host spans (``serving/trace.py``) and its
``host_syncs`` counter, on the CPU.

The recorder on its own: nesting, parents, request uids, self times, an
exception inside a span, and the off state (no clock read, nothing kept).
Then smoke-size drains with the recorder on: a ``ClassifierServer`` with a
shared-clock arbiter (one ``sched.step`` per fused step, one
``engine.lane_load`` per refill with the request's uid, one
``engine.load_flush`` per step that loaded lanes, every span inside
its parent and siblings disjoint, so a step's spans split its duration;
results bit for bit those of the same drain with the recorder off), the
counter's sites, and a ``DecoderServer`` with per-token exit and an
arbiter.
"""
import dataclasses
import itertools
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_smoke_config
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
from repro_torch.models.model import build_model, init_params
from repro_torch.serving import dvfs, engine, trace
from repro_torch.serving.engine import ClassifierServer, DecoderServer, Request

LENGTHS = (12, 16, 9, 24, 32, 16, 27, 12, 5, 30, 20, 14)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    yield
    trace.disable()


def self_ns(recs):
    """Each record's self time: its duration less its children's."""
    out = [r.end_ns - r.start_ns for r in recs]
    for r in recs:
        if r.parent >= 0:
            out[r.parent] -= r.end_ns - r.start_ns
    return out


@pytest.fixture
def fake_clock(monkeypatch):
    """``perf_counter_ns`` as a counter: each read 10 ns after the last."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(ticks))


# ------------------------------------------------------------------ recorder

def test_nesting_parents_uids_and_self_time(fake_clock):
    rec = trace.enable()
    with trace.span("a"):                  # 0
        with trace.span("b", 7):           # 10
            with trace.span("c"):          # 20, 30
                pass
        with trace.span("d", 8):           # 50, 60   (b ends at 40)
            pass
    trace.disable()                        # a ends at 70
    recs = rec.records()
    assert [r.name for r in recs] == ["a", "b", "c", "d"]
    assert [r.parent for r in recs] == [-1, 0, 1, 0]
    assert [r.uid for r in recs] == [None, 7, None, 8]
    assert [(r.start_ns, r.end_ns) for r in recs] == [(0, 70), (10, 40), (20, 30), (50, 60)]
    assert self_ns(recs) == [70 - 30 - 10, 30 - 10, 10, 10]
    assert sum(self_ns(recs)) == recs[0].end_ns - recs[0].start_ns


def test_an_exception_closes_its_spans(fake_clock):
    rec = trace.enable()
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError
    with trace.span("next"):
        pass
    recs = rec.records()
    assert [(r.name, r.parent) for r in recs] == [("outer", -1), ("inner", 0), ("next", -1)]
    assert all(r.end_ns > r.start_ns for r in recs)


def test_an_open_span_reads_as_open(fake_clock):
    rec = trace.enable()
    with trace.span("open"):
        with trace.span("shut"):
            pass
        recs = rec.records()
    assert [(r.name, r.end_ns) for r in recs] == [("open", -1), ("shut", 20)]
    assert recs[1].parent == 0


def test_off_reads_no_clock_and_keeps_nothing(monkeypatch):
    reads = []
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: reads.append(1) or 0)
    rec = trace.enable()
    trace.disable()
    assert trace.current() is None
    a, b = trace.span("x", 1), trace.span("y")
    assert a is b                          # one shared object: nothing allocated per span
    with a:
        with b:
            pass
    assert reads == [] and rec.records() == []


# ---------------------------------------------------------- classifier drain

def _classifier_setup():
    cfg = dataclasses.replace(get_smoke_config("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=False))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = SyntheticCLS(cfg.vocab_size, 32, len(LENGTHS), num_classes=3, seed=2).batch(0)["tokens"]
    tokens = [toks[i][:n] for i, n in enumerate(LENGTHS)]
    # the threshold between the median observed entropies, so exits spread
    prof = ClassifierServer(build_model(cfg), params, batch_lanes=4, buckets=(16, 32), device="cpu")
    for i, t in enumerate(tokens):
        prof.submit(Request(uid=i, tokens=t))
    prof.run()
    ent = np.unique(np.concatenate([prof.done[i].entropy_trace for i in range(len(tokens))]))
    mid = len(ent) // 2
    thr = float(ent[mid - 1] + ent[mid]) / 2
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=thr))
    return cfg, params, tokens


@pytest.fixture(scope="module")
def classifier():
    return _classifier_setup()


def _classifier_drain(classifier, traced: bool):
    cfg, params, tokens = classifier
    stats = albert_layer_stats(seq_len=32)
    stats.n_layers = cfg.n_layers
    ctrl = dvfs.LatencyAwareDVFSController(stats, dvfs.no_early_exit_baseline(stats)["latency_s"] * 0.7)
    srv = ClassifierServer(build_model(cfg), params, batch_lanes=4, buckets=(16, 32), device="cpu",
                           arbiter=dvfs.BatchedDVFSArbiter(ctrl))
    rec = trace.enable() if traced else None
    for i, t in enumerate(tokens):
        srv.submit(Request(uid=100 + i, tokens=t))
    polled = []
    while not srv.sched.idle:
        srv.step()
        polled += srv.poll()
    trace.disable()
    return srv, rec, polled


def _children(recs):
    kids = {}
    for j, r in enumerate(recs):
        kids.setdefault(r.parent, []).append(j)
    return kids


def _check_nested(recs):
    """Every span closed, inside its parent, and disjoint from its
    siblings (so a span's self time is its time in no child)."""
    kids = _children(recs)
    for p, js in kids.items():
        lo, hi = (recs[p].start_ns, recs[p].end_ns) if p >= 0 else (-1, float("inf"))
        prev_end = lo
        for j in js:
            r = recs[j]
            assert r.end_ns >= r.start_ns >= prev_end, (recs[p] if p >= 0 else None, r)
            prev_end = r.end_ns
        assert prev_end <= hi
    assert min(self_ns(recs)) >= 0


def test_classifier_drain_spans(classifier):
    srv, rec, polled = _classifier_drain(classifier, traced=True)
    recs = rec.records()
    _check_nested(recs)
    names = Counter(r.name for r in recs)
    tel = srv.telemetry()
    assert tel["sentences"] == len(LENGTHS) and len(polled) == len(LENGTHS)
    assert names["sched.step"] == tel["dense_steps"] > 0
    assert names["engine.lane_load"] == srv.sched.telemetry()["refills"] == names["dvfs.admit"]
    assert names["sched.submit"] == len(LENGTHS) and names["sched.poll"] == tel["dense_steps"]
    assert names["engine.load_flush"] == tel["load_flushes"] > 0
    # each request's span carries its uid: one load, one admission, and its
    # arbiter's first entropy and retirement
    by = lambda n: sorted(r.uid for r in recs if r.name == n)                       # noqa: E731
    uids = list(range(100, 100 + len(LENGTHS)))
    assert by("engine.lane_load") == by("dvfs.admit") == by("sched.submit") == uids
    assert by("dvfs.retire") == sorted(uids * 2)
    kids = _children(recs)
    self_t = self_ns(recs)
    for k, r in enumerate(recs):
        if r.name != "sched.step":
            continue
        assert [recs[j].name for j in kids[k]] == ["sched.choose", "sched.refill", "engine.lanes_step",
                                                  "sched.retire"]
        step = kids[k][2]
        loads = kids.get(kids[k][1], [])
        # a step that loaded lanes first flushes their staged rows
        assert [recs[j].name for j in kids[step]] == (["engine.load_flush"] if loads else []) + [
            "dvfs.arbitrate", "step.readback"]
        for j in loads:
            assert recs[j].name == "engine.lane_load"
            assert [recs[m].name for m in kids.get(j, [])] == ["dvfs.admit"]
        assert {recs[j].name for j in kids.get(kids[k][3], [])} <= {"dvfs.retire"}
        # the step's spans split its time: their self times sum to its duration
        tree, todo = [], [k]
        while todo:
            j = todo.pop()
            tree.append(j)
            todo += kids.get(j, [])
        assert sum(self_t[j] for j in tree) == r.end_ns - r.start_ns


def test_classifier_results_do_not_depend_on_the_recorder(classifier):
    on, _, polled_on = _classifier_drain(classifier, traced=True)
    off, _, polled_off = _classifier_drain(classifier, traced=False)
    assert [r.uid for r in polled_on] == [r.uid for r in polled_off]
    assert len({r.exit_layer for r in polled_off}) > 1
    for a, b in zip(polled_on, polled_off):
        assert a.exit_layer == b.exit_layer
        assert np.array_equal(a.result, b.result)
        assert a.entropy_trace == b.entropy_trace
        assert a.energy_j == b.energy_j
    assert on.telemetry() == off.telemetry()


def test_host_sync_sites(classifier, monkeypatch):
    """On the CPU nothing waits (``host_syncs`` stays 0); counted at every
    site as if the device were a card: two input copies and one readback
    per fused step (a lane load stages its token row for a non-blocking
    copy, so refills add none)."""
    srv, _, _ = _classifier_drain(classifier, traced=False)
    assert srv.telemetry()["host_syncs"] == 0
    calls = []
    monkeypatch.setattr(engine, "_synced", lambda srv, device, n=1: calls.append(n))
    srv, _, _ = _classifier_drain(classifier, traced=False)
    tel = srv.telemetry()
    assert srv.sched.telemetry()["refills"] > 0
    assert sum(calls) == 3 * tel["dense_steps"]
    monkeypatch.undo()
    card = type("Card", (), {"_host_syncs": 0})()
    engine._synced(card, torch.device("cuda", 0), 2)
    engine._synced(card, torch.device("cpu"), 5)
    assert card._host_syncs == 2


# ------------------------------------------------------------- decoder drain

def _decoder_drain(traced: bool):
    cfg = dataclasses.replace(get_smoke_config("deepseek_7b"), dtype="float32", remat_policy="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    stats = albert_layer_stats(seq_len=16)
    stats.n_layers = cfg.n_layers
    arb = dvfs.BatchedDVFSArbiter(dvfs.LatencyAwareDVFSController(
        stats, dvfs.no_early_exit_baseline(stats)["latency_s"] * 2.0))
    srv = DecoderServer(build_model(cfg), params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,),
                        exit_threshold=1e9, arbiter=arb, device="cpu")
    rec = trace.enable() if traced else None
    for i in range(4):
        srv.submit(Request(uid=i, tokens=np.random.default_rng(i).integers(4, cfg.vocab_size, 4 + i),
                           max_new_tokens=3))
    srv.run()
    trace.disable()
    return srv, rec


def test_decoder_drain_spans():
    srv, rec = _decoder_drain(traced=True)
    recs = rec.records()
    _check_nested(recs)
    names = Counter(r.name for r in recs)
    tel = srv.telemetry()
    assert names["sched.step"] == names["engine.lanes_step"] == tel["decode_steps"] > 0
    assert sorted(r.uid for r in recs if r.name == "engine.lane_load") == [0, 1, 2, 3]
    # per step: the layers-remaining update and the arbitration; the exit
    # depths and entropies, then the tokens, read back; per retiree its
    # final logits row
    assert names["dvfs.arbitrate"] == 2 * tel["decode_steps"]
    assert names["step.readback"] == 2 * tel["decode_steps"] + tel["completed"]
    assert names["dvfs.admit"] == 4 and names["dvfs.retire"] == 4
    off, _ = _decoder_drain(traced=False)
    for i in range(4):
        assert srv.done[i].generated == off.done[i].generated
        assert srv.done[i].token_exit_layers == off.done[i].token_exit_layers
        assert np.array_equal(srv.done[i].result, off.done[i].result)
