"""The classifier's staged lane loads, on the CPU.

``ClassifierServer.lane_load`` writes the lane's padded token row into a
staging buffer and launches nothing; ``_flush_loads``, at the top of the
next fused step (or of a checkpoint), embeds every staged row of the
bucket at once: per replica with staged rows one embedding over [k, S]
and one indexed insert.  Here: one embedding per replica per flush and a
row per refill, a drain whose flushes carry many lanes bit for bit the
drain whose flushes carry one, each row of a [k, S] embedding at the
cell's widths bit for bit the row embedded alone, a checkpoint of a lane
still staged, the ``lane_loads`` / ``load_flushes`` counters, and the
benchmark's reader of them (``engine.loads_per_flush.tput``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from portbench import harness
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
from repro_torch.models.model import build_model, init_params
from repro_torch.serving import dvfs, step_math
from repro_torch.serving.engine import ClassifierServer, Request

LENGTHS = (12, 16, 9, 24, 32, 16, 27, 12, 5, 30, 20, 14)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Smoke-size float32 weights, span off, and the threshold between the
    median observed entropies, so exits spread."""
    cfg = dataclasses.replace(get_smoke_config("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=False))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = SyntheticCLS(cfg.vocab_size, 32, len(LENGTHS), num_classes=3, seed=5).batch(0)["tokens"]
    tokens = [toks[i][:n] for i, n in enumerate(LENGTHS)]
    prof = ClassifierServer(build_model(cfg), params, batch_lanes=4, buckets=(16, 32), device="cpu")
    for i, t in enumerate(tokens):
        prof.submit(Request(uid=i, tokens=t))
    prof.run()
    ent = np.unique(np.concatenate([prof.done[i].entropy_trace for i in range(len(tokens))]))
    mid = len(ent) // 2
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(
        cfg.edgebert.early_exit, entropy_threshold=float(ent[mid - 1] + ent[mid]) / 2))
    return cfg, params, tokens


def _server(setup, replicas=1, arbiter=True):
    cfg, params, _ = setup
    arb = None
    if arbiter:
        stats = albert_layer_stats(seq_len=32)
        stats.n_layers = cfg.n_layers
        arb = dvfs.BatchedDVFSArbiter(dvfs.LatencyAwareDVFSController(
            stats, dvfs.no_early_exit_baseline(stats)["latency_s"] * 0.7))
    return ClassifierServer(build_model(cfg), params, batch_lanes=4, buckets=(16, 32), device="cpu",
                            arbiter=arb, replicas=replicas)


@pytest.mark.parametrize("replicas", [1, 2])
def test_one_embedding_per_replica_per_flush(setup, replicas, monkeypatch):
    """Every flush embeds once for each replica with staged rows, that
    replica's rows alone; the rows over all flushes are the refills."""
    rows = []
    embed = step_math.classifier_embed

    def counting(model, params, tokens):
        rows.append(tokens.shape[0])
        return embed(model, params, tokens)

    monkeypatch.setattr(step_math, "classifier_embed", counting)
    srv = _server(setup, replicas=replicas)
    flush, flushes = srv._flush_loads, []

    def watched(bucket):
        staged, n = list(srv._bstate[bucket]["staged"]), len(rows)
        flush(bucket)
        if any(staged):
            flushes.append(([k for k in staged if k], rows[n:]))
        assert not any(srv._bstate[bucket]["staged"]) and (any(staged) or len(rows) == n)

    srv._flush_loads = watched
    for i, t in enumerate(setup[2]):
        srv.submit(Request(uid=i, tokens=t))
    tel = srv.run()
    assert tel["sentences"] == len(LENGTHS)
    assert flushes and all(staged == got for staged, got in flushes)
    assert sum(rows) == srv.sched.telemetry()["refills"] == tel["lane_loads"] == len(LENGTHS)
    assert tel["load_flushes"] == len(flushes) < len(LENGTHS)
    # the first refill loads lanes of every replica: one flush embeds for each
    assert len(flushes[0][0]) == replicas and sum(flushes[0][0]) > replicas


def test_flushes_of_many_lanes_match_flushes_of_one(setup):
    """All requests submitted at once (flushes of up to four lanes) against
    the same requests submitted one per step (flushes of one): the same
    exits, entropies and logits, bit for bit."""
    tokens = setup[2]
    many = _server(setup)
    for i, t in enumerate(tokens):
        many.submit(Request(uid=i, tokens=t))
    many.run()
    one = _server(setup)
    for i, t in enumerate(tokens):
        one.submit(Request(uid=i, tokens=t))
        while one.pending:
            one.step()
    one.run()
    t_many, t_one = many.telemetry(), one.telemetry()
    assert t_many["lane_loads"] == t_one["lane_loads"] == len(tokens)
    assert t_many["load_flushes"] < len(tokens) and t_one["load_flushes"] == len(tokens)
    assert len({many.done[i].exit_layer for i in range(len(tokens))}) > 1
    for i in range(len(tokens)):
        a, b = many.done[i], one.done[i]
        assert a.exit_layer == b.exit_layer
        assert a.entropy_trace == b.entropy_trace
        assert np.array_equal(a.result, b.result)


@pytest.mark.parametrize("k", [1, 8, 64])
def test_batched_embedding_rows_equal_rows_embedded_alone(k):
    """At the benchmark cell's widths (embedding 128, d 768, bucket 128),
    each row of an embedding over [k, S] has the bits of the row embedded
    alone: a lane's answer does not depend on which lanes load with it."""
    cfg = dataclasses.replace(get_config("albert_edgebert"), dtype="float32")
    model, g = build_model(cfg), torch.Generator().manual_seed(k)
    p = {"embed": {"tok": torch.randn(cfg.vocab_size, cfg.embed_dim, generator=g) * 0.02,
                   "proj": torch.randn(cfg.embed_dim, cfg.d_model, generator=g) * 0.09,
                   "pos": torch.randn(cfg.max_seq_len, cfg.d_model, generator=g) * 0.02}}
    toks = torch.randint(0, cfg.vocab_size, (k, 128), generator=g)
    toks[:, 100:] = 0                                   # bucket padding
    h = step_math.classifier_embed(model, p, toks)
    assert h.shape == (k, 128, cfg.d_model)
    for i in range(k):
        assert torch.equal(h[i], step_math.classifier_embed(model, p, toks[i:i + 1])[0]), i


def test_lanes_insert_writes_the_named_rows():
    h = torch.zeros(6, 3, 2)
    new = torch.arange(18, dtype=torch.float32).reshape(3, 3, 2)
    step_math.lanes_insert(h, torch.tensor([4, 0, 2]), new)
    assert torch.equal(h[[4, 0, 2]], new) and not h[[1, 3, 5]].any()


def test_checkpoint_of_a_staged_lane_sees_its_row(setup):
    """A lane loaded and checkpointed before any step: the checkpoint
    flushes first, so it holds the lane's embedded row."""
    srv = _server(setup, arbiter=False)
    t = setup[2][3]                                     # 24 tokens: bucket 32
    req = Request(uid=0, tokens=t)
    srv.bucket_begin(32)
    srv.lane_load(32, 2, req)
    st = srv._bstate[32]
    assert st["staged"] == [1] and not st["h"][0][2].any()
    payload = srv.lane_checkpoint(32, 2, req)
    padded = np.zeros(32, np.int64)
    padded[: len(t)] = t
    want = step_math.classifier_embed(srv.model, srv.params, torch.from_numpy(padded[None]))[0]
    assert torch.equal(payload["h"], want) and payload["len"] == len(t)
    assert torch.equal(st["h"][0][2], want) and st["staged"] == [0]
    # nothing staged: a second checkpoint flushes nothing
    srv.lane_checkpoint(32, 2, req)
    tel = srv.telemetry()
    assert (tel["lane_loads"], tel["load_flushes"]) == (1, 1)


def test_telemetry_counts_loads_and_flushes(setup):
    """``lane_loads`` counts the rows staged, ``load_flushes`` the steps'
    flushes that embedded some; a step with nothing staged flushes none."""
    srv = _server(setup, arbiter=False)
    tel = srv.telemetry()
    assert (tel["lane_loads"], tel["load_flushes"]) == (0, 0)
    srv.bucket_begin(16)
    short = [t for t in setup[2] if len(t) <= 16]
    for lane in (0, 1, 3):
        srv.lane_load(16, lane, Request(uid=lane, tokens=short[lane]))
    tel = srv.telemetry()
    assert (tel["lane_loads"], tel["load_flushes"]) == (3, 0)
    active = np.array([True, True, False, True])
    srv.lanes_step(16, active)
    srv.lanes_step(16, active)
    tel = srv.telemetry()
    assert (tel["lane_loads"], tel["load_flushes"]) == (3, 1)
    srv.lane_load(16, 2, Request(uid=2, tokens=short[2]))
    srv.lanes_step(16, np.ones(4, bool))
    tel = srv.telemetry()
    assert (tel["lane_loads"], tel["load_flushes"]) == (4, 2)


# ------------------------------------------------------ the benchmark's reader

def _ctx(tel0, tel1):
    return {"w": {"t0": 1.0, "h_end": 2.0, "tel0": tel0, "tel1": tel1}}


def test_loads_per_flush_reader_by_hand():
    """82 lanes loaded over 10 flushes in the window's host part."""
    read = harness.load_reader("engine.loads_per_flush.tput")
    got = read(_ctx({"lane_loads": 100, "load_flushes": 10, "dense_steps": 10},
                    {"lane_loads": 182, "load_flushes": 20, "dense_steps": 20}))
    assert got == pytest.approx(8.2, rel=1e-12)


@pytest.mark.parametrize("tel0,tel1", [
    # a program without the counters (the parent of the staged loads)
    ({"dense_steps": 10, "host_syncs": 100}, {"dense_steps": 12, "host_syncs": 132}),
    # no flush inside the window
    ({"lane_loads": 5, "load_flushes": 3}, {"lane_loads": 5, "load_flushes": 3}),
])
def test_loads_per_flush_reader_reads_nothing_without_flushes(tel0, tel1):
    assert harness.load_reader("engine.loads_per_flush.tput")(_ctx(tel0, tel1)) is None
