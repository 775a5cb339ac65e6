"""The readers of the port's own spans, the idle walk by program span and
the clock check, on hand-made records with known answers; and, on the
card, the clock check over a traced drain and the ``host_syncs`` counter's
readers.

Two fused steps inside the window's host part [B, B + 10000] and one
after it, nested four deep (``sched.step`` > ``sched.refill`` >
``engine.lane_load`` > ``dvfs.admit``); times in ns from B."""
import dataclasses
from collections import namedtuple

import numpy as np
import pytest

from portbench import harness, program, tracing

B = 1_000_000_000
R = namedtuple("R", "start_ns end_ns name parent uid")


def _recs():
    rows = [
        (0, 10, "sched.submit", -1, 7),           # 0: outside every step
        (100, 1100, "sched.step", -1, None),      # 1
        (100, 200, "sched.choose", 1, None),      # 2
        (200, 600, "sched.refill", 1, None),      # 3
        (250, 450, "engine.lane_load", 3, 7),     # 4
        (400, 450, "dvfs.admit", 4, 7),           # 5
        (600, 1000, "engine.lanes_step", 1, None),  # 6
        (600, 650, "dvfs.arbitrate", 6, None),    # 7
        (900, 1000, "step.readback", 6, None),    # 8
        (1000, 1080, "sched.retire", 1, None),    # 9
        (1010, 1030, "dvfs.retire", 9, 7),        # 10
        (2000, 2500, "sched.step", -1, None),     # 11
        (2000, 2100, "sched.choose", 11, None),   # 12
        (2100, 2150, "sched.refill", 11, None),   # 13
        (2150, 2450, "engine.lanes_step", 11, None),  # 14
        (2150, 2200, "dvfs.arbitrate", 14, None),  # 15
        (2400, 2450, "step.readback", 14, None),  # 16
        (2450, 2500, "sched.retire", 11, None),   # 17
        (20000, 21000, "sched.step", -1, None),   # 18: after the window's host part
        (20100, 20900, "engine.lanes_step", 18, None),  # 19
    ]
    return [R(B + a, B + b, n, p, u) for a, b, n, p, u in rows]


class _Rec:
    def __init__(self, recs):
        self._recs = recs

    def records(self):
        return list(self._recs)


def _ctx(with_program=True, tel=None):
    tel0, tel1 = tel or ({"dense_steps": 10, "host_syncs": 100}, {"dense_steps": 12, "host_syncs": 132})
    ctx = {"w": {"t0": 1.0, "h_end": 1.00001, "tel0": tel0, "tel1": tel1}}
    if with_program:
        ctx["program"] = _Rec(_recs())
    return ctx


@pytest.mark.parametrize("name,want", [
    # sched.* self: (20 + 100 + 200 + 60) + (0 + 100 + 50 + 50) ns over 2 steps
    ("sched.self_ms_per_step.tput", 290e-6),
    # engine.lane_load self 200 - 50 ns, one load
    ("engine.lane_load_us.tput", 0.15),
    # engine.lanes_step self (400 - 50 - 100) + (300 - 50 - 50) ns over 2 steps
    ("step.host_ms_per_step.tput", 225e-6),
    # dvfs.*: (50 + 50 + 20) + 50 ns over 2 steps
    ("dvfs.host_ms_per_step.tput", 85e-6),
    # 32 syncs over 2 steps
    ("host.syncs_per_step.tput", 16.0),
])
def test_readers_by_hand(name, want):
    assert harness.load_reader(name)(_ctx()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["sched.self_ms_per_step.tput", "engine.lane_load_us.tput",
                                  "step.host_ms_per_step.tput", "dvfs.host_ms_per_step.tput"])
def test_span_readers_read_nothing_without_the_recorder(name):
    assert harness.load_reader(name)(_ctx(with_program=False)) is None


def test_sync_reader_reads_nothing_without_the_counter():
    tel = ({"dense_steps": 10}, {"dense_steps": 12})
    assert harness.load_reader("host.syncs_per_step.tput")(_ctx(tel=tel)) is None


def test_idle_by_innermost_program_span():
    """Busy 300-400, 700-950 and 2200-2400 in a window of 3000: 2450 ns
    idle, each piece under the innermost program span open then, else the
    benchmark's span, else outside any span (10-90, 1500-1990 and
    2510-3000)."""
    spans = tracing.Spans(True)
    spans.outer = [(B + 90, B + 1100, "step"), (B + 1100, B + 1500, "poll"), (B + 1990, B + 2510, "step")]
    spans.inner = [(B + 240, B + 460, "lane_load"), (B + 590, B + 1005, "lanes_step")]
    t = {"lo_ns": B, "hi_ns": B + 3000, "busy": [(B + 300, B + 400), (B + 700, B + 950), (B + 2200, B + 2400)]}
    gaps = dict(program.idle_gaps(t, _recs(), spans, top=100))
    want = {program.OUTSIDE: 1060, "sched.submit": 10, "step": 30, "poll": 400, "sched.choose": 200,
            "sched.refill": 250, "engine.lane_load": 50, "dvfs.admit": 50, "dvfs.arbitrate": 100,
            "engine.lanes_step": 50, "step.readback": 100, "sched.retire": 110, "dvfs.retire": 20, "sched.step": 20}
    assert gaps.keys() == want.keys()
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v * 1e-9), k
    assert sum(gaps.values()) == pytest.approx(2450e-9)
    # the ten largest, largest first
    top = program.idle_gaps(t, _recs(), spans)
    assert len(top) == 10 and top[0][0] == program.OUTSIDE


def test_idle_without_program_spans_is_the_benchmarks_walk():
    """With no program records the walk gives ``tracing.summary``'s gaps."""
    evs = [(1100, 1300, "k1"), (1200, 1400, "k2"), (1600, 1700, "k1")]
    spans = tracing.Spans(True)
    spans.outer = [(0, 500, "step"), (500, 900, "poll")]
    spans.inner = [(400, 500, "lanes_step")]

    class W:
        host0, host1, epoch_minus_host = 0, 1000, 1000

        def events(self):
            return evs

    s = tracing.summary(W(), spans)
    assert sorted(program.idle_gaps(s, [], spans)) == sorted(s["idle_gaps"])


def test_readback_skew_by_hand():
    t = {"lo_ns": B, "hi_ns": B + 3000, "ops": [(B + 950, B + 980, "Memcpy DtoH (Device -> Pageable)"),
                                                (B + 300, B + 310, "Memcpy HtoD (Pageable -> Device)"),
                                                (B + 2430, B + 2460, "Memcpy DtoH (Device -> Pageable)")]}
    got = program.readback_skew(t, _recs())
    # ends 980 (span 900-1000) and 2460 (span 2400-2450): 20 ns early, 10 ns
    # late, 1.5 us apart
    assert got == {"steps": 2, "copies": 2, "inside": 0.5, "worst_us": pytest.approx(0.01),
                   "end_gap_first_us": pytest.approx(-0.02), "end_gap_last_us": pytest.approx(0.01),
                   "drift_us_per_s": pytest.approx(0.03 / 1.45e-6)}
    assert program.readback_skew(dict(t, ops=[]), _recs()) is None


def test_open_spans_are_left_out():
    recs = _recs()
    recs[19] = recs[19]._replace(end_ns=-1)
    recs[18] = recs[18]._replace(end_ns=-1)
    assert program.steps(recs, B, B + 10 ** 9)[0] == 2
    assert all(b > a for a, b, _ in program.segments(recs))


def test_clock_tie_over_a_traced_drain(cuda):
    """On the card: a smoke-size classifier drain with the arbiter under
    the traced window (``tracing.DeviceWindow``) and the port's recorder:
    one device-to-host copy per fused step, each step's paired with its
    ``step.readback`` span.  Whether the copy's end, mapped onto the host
    clock by the window's tie, falls inside the span is the tie's
    (``DeviceWindow``'s) property, not the program's: the share and the
    worst distance are printed (``-s``), not judged."""
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving import dvfs, trace
    from repro_torch.serving.engine import ClassifierServer, Request

    cfg = dataclasses.replace(get_smoke_config("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=False),
                            early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=0.0))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = ClassifierServer(build_model(cfg), params, batch_lanes=8, buckets=(32,), device=cuda,
                           arbiter=dvfs.BatchedDVFSArbiter(dvfs.default_albert_controller(1e-3, seq_len=32,
                                                                                         n_layers=cfg.n_layers)))
    rng = np.random.default_rng(0)

    def drain(n, uid0):
        for i in range(n):
            srv.submit(Request(uid=uid0 + i, tokens=rng.integers(3, cfg.vocab_size, 20 + i % 12)))
        while srv.step() is not None:
            srv.poll()

    drain(16, 0)                                  # built and warm
    win = tracing.DeviceWindow()
    win.init()
    rec = trace.enable()
    try:
        win.start()
        drain(64, 1000)
        win.stop()
    finally:
        trace.disable()
    t = tracing.summary(win, tracing.Spans(False))
    got = program.readback_skew(t, rec.records())
    print("readback_skew", got)
    assert got["steps"] >= 64 // 8 * cfg.n_layers
    assert got["copies"] == got["steps"]
