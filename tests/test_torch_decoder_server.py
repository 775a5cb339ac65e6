"""The decoder serving path, port against the JAX package: DecoderServer
drains (per-token early exit, shared-clock arbiter, preemption,
self-speculative decode), probe_exit_threshold, the decoder case of
test_admission.py and the cross-engine cases of test_arbiter_properties.py.

Each scenario runs through ``repro`` and through ``repro_torch`` (smoke
``deepseek_7b`` in float32, and for the cross-engine cases smoke
``albert_edgebert`` beside it; JAX-initialised params carried over by
``bridge.params_from_numpy``; the port's servers on the CPU, where its
kernel route runs the plain versions, the JAX servers on their Pallas route
in interpret mode), makes the reference test's assertions on both sides and
compares what both did.  Generated tokens, exit depths, integers, flags and
strings are equal; modeled floats (energies, clocks, quotes) agree within
rel 1e-9, the same Python arithmetic on the same modeled quantities;
entropy traces, final logits and thresholds from entropies within 1e-5
(float32 sums in another order).
"""
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.early_exit import ExitThresholdSchedule as JSchedule
from repro.core.early_exit import PositionBinnedExitCalibrator as JCalibrator
from repro.data.synthetic import SyntheticCLS
from repro.hwmodel.edgebert_accel import albert_layer_stats as j_stats
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving.admission import AdmissionController as JAdmission
from repro.serving.engine import ClassifierServer as JClassifier
from repro.serving.engine import DecoderServer as JDecoder
from repro.serving.engine import Request as JRequest
from repro.serving.engine import probe_exit_threshold as j_probe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.early_exit import ExitThresholdSchedule as TSchedule
from repro_torch.core.early_exit import PositionBinnedExitCalibrator as TCalibrator
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving.admission import AdmissionController as TAdmission
from repro_torch.serving.engine import ClassifierServer as TClassifier
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import probe_exit_threshold as t_probe

ATOL = 1e-5

JAX = SimpleNamespace(name="jax", smoke=j_smoke, build=j_build, Decoder=JDecoder, Classifier=JClassifier,
                      Request=JRequest, Admission=JAdmission, dvfs=jdvfs, stats=j_stats, probe=j_probe,
                      Schedule=JSchedule, Calibrator=JCalibrator,
                      dec_kw={"use_pallas": True}, cls_kw={}, probe_kw={})
TORCH = SimpleNamespace(name="torch", smoke=t_smoke, build=t_build, Decoder=TDecoder, Classifier=TClassifier,
                        Request=TRequest, Admission=TAdmission, dvfs=tdvfs, stats=t_stats, probe=t_probe,
                        Schedule=TSchedule, Calibrator=TCalibrator,
                        dec_kw={"device": "cpu"}, cls_kw={"device": "cpu"}, probe_kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JPARAMS = {}


def _model(ns, arch="deepseek_7b", seed=1, **kw):
    """The smoke model of ``arch`` in float32 and the JAX-initialised params
    (one draw per (arch, seed, kw), carried across for the port)."""
    cfg = dataclasses.replace(ns.smoke(arch), dtype="float32", remat_policy="none", **kw)
    if arch == "albert_edgebert":       # threshold ~0: deterministic full depth
        cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                               entropy_threshold=1e-9))
    key = (arch, seed, tuple(sorted(kw.items())))
    if key not in _JPARAMS:
        jcfg = dataclasses.replace(j_smoke(arch), dtype="float32", remat_policy="none", **kw)
        _JPARAMS[key] = j_build(jcfg).init_params(jax.random.PRNGKey(seed))
    params = _JPARAMS[key]
    if ns is TORCH:
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return ns.build(cfg), params, cfg


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, cfg.vocab_size, size=L).astype(np.int32) for L in lengths]


def _arbiter(ns, n_layers, mult=2.0, seq_len=16):
    stats = ns.stats(seq_len=seq_len)
    stats.n_layers = n_layers
    ctrl = ns.dvfs.LatencyAwareDVFSController(stats, ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * mult)
    return ns.dvfs.BatchedDVFSArbiter(ctrl)


REQ_INT = ("uid", "bucket", "preempted", "ckpt_depth", "arrival_step", "first_compute_step", "retire_step")
REQ_FLOAT = ("deadline_s", "arrival_s", "admit_s", "retire_s", "energy_j", "latency_s", "op_vdd", "op_freq_hz")


def _same_float(a, b, path):
    if a is None or b is None:
        assert a is None and b is None, path
    else:
        assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)


# telemetry the port keeps and the JAX package has no counterpart of: the
# blocking copies between host and card, and the classifier's lane loads
# staged and their flushes
PORT_ONLY = ("host_syncs", "lane_loads", "load_flushes", "depth_groups", "lane_layers_global",
             "lane_layers_local")


def assert_same(a, b, path="out"):
    """Integers, flags, strings and None equal; floats within rel 1e-9
    (``a`` the JAX package's, ``b`` the port's less its ``PORT_ONLY``
    keys)."""
    if isinstance(a, dict):
        if isinstance(b, dict):
            b = {k: v for k, v in b.items() if k not in PORT_ONLY}
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        _same_float(a, b, path)
    else:
        assert a == b, (path, a, b)


def assert_same_servers(js, ts):
    """The two drains did the same: telemetry, and per request its tokens,
    exits, lifecycle stamps and modeled energy; entropy traces and final
    logits within 1e-5."""
    assert_same(js.telemetry(), ts.telemetry())
    assert sorted(js.done) == sorted(ts.done)
    for uid in js.done:
        a, b = js.done[uid], ts.done[uid]
        assert a.generated == b.generated, uid
        assert a.token_exit_layers == b.token_exit_layers, uid
        for f in REQ_INT:
            assert getattr(a, f) == getattr(b, f), (uid, f)
        for f in REQ_FLOAT:
            _same_float(getattr(a, f), getattr(b, f), (uid, f))
        assert len(a.entropy_trace) == len(b.entropy_trace), uid
        np.testing.assert_allclose(b.entropy_trace, a.entropy_trace, atol=ATOL, rtol=0)
        assert (a.result is None) == (b.result is None), uid
        if a.result is not None:
            np.testing.assert_allclose(b.result, np.asarray(a.result), atol=ATOL, rtol=0)


def _threshold(q=0.5, max_new=5):
    """The probe's threshold from the JAX package (the port's is checked
    against it in test_probe_exit_threshold)."""
    model, params, cfg = _model(JAX, n_layers=4)
    return j_probe(model, params, _prompts(cfg, (6, 5, 7, 4, 6)), max_new_tokens=max_new, quantile=q)


# ---------------------------------------------------------------------------
# drains
# ---------------------------------------------------------------------------


def _scenario(name, ns, thr):
    """One drain of the named scenario on package ``ns``; returns the server."""
    model, params, cfg = _model(ns, n_layers=4)
    prompts = _prompts(cfg, (6, 5, 7, 4, 6))
    kw = dict(batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), **ns.dec_kw)
    new = 4
    if name == "full_depth":
        kw.update(buckets=None)
    elif name == "exit":
        kw.update(exit_threshold=thr)
    elif name == "exit_two_buckets":
        prompts = _prompts(cfg, (4, 10, 4, 10), seed=3)
        kw.update(exit_threshold=thr, max_seq=64, buckets=(8, 16))
        new = 3
    elif name == "exit_arbiter":
        kw.update(exit_threshold=thr, arbiter=_arbiter(ns, cfg.n_layers))
    elif name == "exit_preempt":
        kw.update(exit_threshold=thr, preempt=True)
        new = 6
    elif name == "spec4":
        kw.update(exit_threshold=thr, spec_window=4)
    elif name == "spec3_schedule_arbiter_preempt":
        cal = ns.Calibrator(cfg.n_layers, max_pos=32)
        for p, x in ((0, 1), (1, 1), (2, 2), (9, 4), (12, 3)):
            cal.observe(p, x)
        kw.update(threshold_schedule=ns.Schedule.from_calibrator(thr, cal, band_edges=(thr,),
                                                                 band_scales=(1.0, 1.002)),
                  spec_window=3, arbiter=_arbiter(ns, cfg.n_layers), preempt=True)
        new = 6
    srv = ns.Decoder(model, params, **kw)
    for i, p in enumerate(prompts):
        srv.submit(ns.Request(uid=i, tokens=p, max_new_tokens=new))
    if kw.get("preempt"):
        srv.step()
        srv.submit(ns.Request(uid=99, tokens=prompts[0][:4], max_new_tokens=2, deadline_s=30.0))
    srv.run()
    return srv


SCENARIOS = ("full_depth", "exit", "exit_two_buckets", "exit_arbiter", "exit_preempt", "spec4",
             "spec3_schedule_arbiter_preempt")


@pytest.mark.parametrize("name", SCENARIOS)
def test_decoder_drain_matches_jax(name):
    thr = _threshold(q=0.8)
    js, ts = _scenario(name, JAX, thr), _scenario(name, TORCH, thr)
    assert_same_servers(js, ts)
    st = ts.telemetry()
    assert st["completed"] == len(ts.done)
    n_buckets = 2 if name == "exit_two_buckets" else 1
    assert st["decode_traces"] == n_buckets and st["prefill_traces"] == n_buckets
    if "preempt" in name:
        assert st["preemptions"] >= 1
    if "arbiter" in name:
        assert st["accepted_slo_misses"] == 0
        assert all(r.energy_j > 0 for r in ts.done.values())
    if name.startswith("spec"):
        assert st["tokens_per_fused_step"] >= 1.0


def test_probe_exit_threshold():
    out = {}
    for ns in (JAX, TORCH):
        model, params, cfg = _model(ns, n_layers=4)
        prompts = _prompts(cfg, (6, 5, 7, 4, 6))
        out[ns.name] = [ns.probe(model, params, prompts, max_new_tokens=5, quantile=q, **ns.probe_kw)
                        for q in (0.3, 0.5, 0.8)]
    np.testing.assert_allclose(out["torch"], out["jax"], atol=ATOL, rtol=0)
    assert out["torch"][0] <= out["torch"][1] <= out["torch"][2]


def test_spec_server_matches_ee_server_bitwise_in_the_port():
    """The reference's claim inside the port: every speculative slot is
    the same decode_step_ee at the same shapes, so W = 4's accepted tokens,
    exit depths and final logits equal W = 1's bit for bit."""
    thr = _threshold(q=0.8)
    s1, s4 = _scenario("exit", TORCH, thr), _scenario("spec4", TORCH, thr)
    for i in s1.done:
        assert s4.done[i].generated == s1.done[i].generated
        assert s4.done[i].token_exit_layers == s1.done[i].token_exit_layers
        np.testing.assert_array_equal(s4.done[i].result, s1.done[i].result)
    assert s4.telemetry()["tokens_per_fused_step"] > 1.0


def _isolated_ee_decode(model, params, prompt, max_new, bucket, threshold):
    """One request alone: full-depth ``decode_step``s over the prompt, then
    ``decode_step_ee`` per token (the reference test's ground truth)."""
    cache = model.init_cache(1, bucket, device="cpu")
    for t in range(len(prompt) - 1):
        _, cache = model.decode_step(params, cache, torch.tensor([[int(prompt[t])]]), t)
    pos, cur, outs, exits, last = len(prompt) - 1, int(prompt[-1]), [], [], None
    for _ in range(max_new):
        lg, cache, xl, _ = model.decode_step_ee(params, cache, torch.tensor([[cur]]), pos, threshold)
        cur = int(lg[0, -1].argmax())
        outs.append(cur)
        exits.append(int(xl[0]))
        last = lg[0, -1].numpy()
        pos += 1
        if pos >= bucket - 1:
            break
    return outs, exits, last


def test_fused_lanes_match_isolated_decode():
    """In the port: every request's tokens and exit depths through the
    fused, bucketed, refilled lanes equal an isolated single-request
    decode's, final logits within 1e-4 (the lanes run at M = 2, the
    reference at M = 1), with a real spread of exit depths."""
    thr = _threshold(q=0.5)
    srv = _scenario("exit", TORCH, thr)
    model, params, cfg = _model(TORCH, n_layers=4)
    seen = set()
    for i, p in enumerate(_prompts(cfg, (6, 5, 7, 4, 6))):
        toks, exits, last = _isolated_ee_decode(model, params, p, 4, 16, thr)
        assert srv.done[i].generated == toks and srv.done[i].token_exit_layers == exits, i
        np.testing.assert_allclose(srv.done[i].result, last, atol=1e-4, rtol=0)
        seen.update(exits)
    assert len(seen) > 1


def _dvfs_setup(ns):
    model, params, cfg = _model(ns, n_layers=4)
    stats = ns.stats(seq_len=16)
    stats.n_layers = cfg.n_layers
    target = ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * 2.0
    return model, params, cfg, stats, target


def test_exit_decode_beats_full_depth_energy():
    """Identical traffic with feasible SLOs: exit-enabled decode spends less
    modeled energy than full depth at zero accepted-SLO misses; both
    packages, the same numbers."""
    thr = _threshold(q=0.5)

    def scenario(ns):
        model, params, cfg, stats, target = _dvfs_setup(ns)
        out = {}
        for label, t in (("full", None), ("exit", thr)):
            srv = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,),
                             arbiter=ns.dvfs.BatchedDVFSArbiter(ns.dvfs.LatencyAwareDVFSController(stats, target)),
                             exit_threshold=t, **ns.dec_kw)
            for i, p in enumerate(_prompts(cfg, (6, 5, 7, 4), seed=7)):
                srv.submit(ns.Request(uid=i, tokens=p, max_new_tokens=5, deadline_s=target * 10))
            out[label] = srv.run()
        assert out["full"]["accepted_slo_misses"] == out["exit"]["accepted_slo_misses"] == 0
        assert out["exit"]["avg_token_exit_layer"] < out["full"]["avg_token_exit_layer"] == cfg.n_layers
        assert out["exit"]["energy_j"] < out["full"]["energy_j"]
        return out

    _both(scenario)


def test_cold_calibrator_quotes_full_depth_and_lut_tightens():
    """Admission prices a cold decoder at full depth (the full-depth token
    work at the max op plus one switch stall) and tightens once the
    position LUT has seen shallow exits; EDF's remaining steps read the same
    LUT."""
    thr = _threshold(q=0.5)

    def scenario(ns):
        model, params, cfg, stats, target = _dvfs_setup(ns)
        prompts = _prompts(cfg, (6, 5, 7, 4), seed=7)
        arb = ns.dvfs.BatchedDVFSArbiter(ns.dvfs.LatencyAwareDVFSController(stats, target))
        srv = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), arbiter=arb,
                         exit_threshold=thr, **ns.dec_kw)
        ac = ns.Admission(srv)
        q = ac.quote(ns.Request(uid=0, tokens=prompts[0], max_new_tokens=5, deadline_s=1.0))
        want = arb.min_latency_quote(5.0, srv._cycles_for(16))
        assert q.service_s == pytest.approx(want)
        req = ns.Request(uid=2, tokens=prompts[0], max_new_tokens=4)
        cold_steps = srv.predict_remaining_steps(16, req, 0)
        assert cold_steps == pytest.approx(4.0)
        for pos in range(5):
            srv.calib.observe(pos, 1)
        q2 = ac.quote(ns.Request(uid=1, tokens=prompts[0], max_new_tokens=5, deadline_s=1.0))
        assert q2.service_s < q.service_s
        warm_steps = srv.predict_remaining_steps(16, req, 0)
        assert warm_steps == pytest.approx(4.0 / cfg.n_layers)
        return [q.service_s, q.wait_s, q.min_deadline_s, q2.service_s, q2.min_deadline_s, cold_steps, warm_steps]

    _both(scenario)


def test_retired_payloads_dropped_after_poll_unless_pinned():
    thr = _threshold(q=0.5)

    def scenario(ns):
        model, params, cfg = _model(ns, n_layers=4)
        srv = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,),
                         exit_threshold=thr, **ns.dec_kw)
        for i, p in enumerate(_prompts(cfg, (6, 5, 7, 4), seed=7)):
            srv.submit(ns.Request(uid=i, tokens=p, max_new_tokens=3))
        polled = []
        while srv.step() is not None:
            polled.extend(srv.poll())
        polled.extend(srv.poll())
        assert len(polled) == 4 and len(srv.done) == 0
        st = srv.telemetry()
        assert st["completed"] == 4 and st["tokens"] == sum(len(r.generated) for r in polled)
        return {"uids": [r.uid for r in polled], "generated": [r.generated for r in polled], "tel": st}

    _both(scenario)


# ---------------------------------------------------------------------------
# test_spec_properties.py: the seeded sweeps (the hypothesis cases skip
# where hypothesis is not installed, as they do there)
# ---------------------------------------------------------------------------

SPEC_W = 4


def _spec_block(ns, model, params, prompt, threshold):
    """One lane's prompt through full-depth decode steps, then one
    speculative block; the JAX side under ``jit`` (one trace for every
    position and threshold: both are traced operands)."""
    if ns is TORCH:
        step, spec = model.decode_step, model.decode_step_spec
        cache = model.init_cache(1, 16, device="cpu")
    else:
        step = jax.jit(model.decode_step)
        spec = jax.jit(model.decode_step_spec, static_argnums=(5,))
        cache = model.init_cache(1, 16)
    for t in range(len(prompt) - 1):
        _, cache = step(params, cache, np.asarray([[int(prompt[t])]]), t)
    _, _, _, xl, _, acc = spec(params, cache, np.asarray([[int(prompt[-1])]]), len(prompt) - 1,
                               np.float32(threshold), SPEC_W)
    return np.asarray(xl)[0], np.asarray(acc)[0]


def test_seeded_sweep_acceptance_rises_with_agreement():
    """Along a loosening threshold sweep the accepted prefix is 1 + the
    leading run of off-ramp drafts (contiguous), and mean agreement and
    acceptance rise together; both packages, the same blocks."""
    def scenario(ns):
        model, params, cfg = _model(ns, n_layers=4)
        rows, blocks = [], []
        for thr in (-1.0, 5.8, 6.0, 6.2, 6.6, np.inf):
            accs, agrees = [], []
            for p in _prompts(cfg, (5, 6, 4, 7, 5, 6), seed=13):
                xl, acc = _spec_block(ns, model, params, p, thr)
                a = int(acc.sum())
                assert 1 <= a <= SPEC_W and acc[:a].all() and not acc[a:].any()
                agree = 0
                while agree < SPEC_W and xl[agree] < cfg.n_layers:
                    agree += 1
                assert a == min(SPEC_W, agree + 1)
                accs.append(a / SPEC_W)
                agrees.append(agree / SPEC_W)
                blocks.append([int(x) for x in xl] + [a])
            rows.append((float(np.mean(agrees)), float(np.mean(accs))))
        accs = [r[1] for r in rows]
        assert [r[0] for r in rows] == sorted(r[0] for r in rows) and accs == sorted(accs)
        assert accs[0] == 1.0 / SPEC_W and accs[-1] == 1.0
        return blocks

    _both(scenario)


def test_seeded_sweep_energy_per_token_below_full_depth():
    def scenario(ns):
        model, params, cfg, stats, target = _dvfs_setup(ns)
        thr = ns.probe(model, params, _prompts(cfg, (6, 5, 7, 4), seed=0), max_new_tokens=5, quantile=0.8,
                       **ns.probe_kw)

        def drain(seed, threshold, W):
            arb = ns.dvfs.BatchedDVFSArbiter(ns.dvfs.LatencyAwareDVFSController(stats, target))
            srv = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), arbiter=arb,
                             exit_threshold=threshold, spec_window=W, **ns.dec_kw)
            for i, p in enumerate(_prompts(cfg, (6, 5, 7, 4), seed=seed)):
                srv.submit(ns.Request(uid=i, tokens=p, max_new_tokens=5, deadline_s=target * 10))
            st = srv.run()
            return st, {i: srv.done[i].energy_j / len(srv.done[i].generated) for i in range(4)}

        out = []
        for seed in (0, 1, 2):
            (spec, spec_req), (full, full_req) = drain(seed, thr, SPEC_W), drain(seed, None, 1)
            assert spec["accepted_slo_misses"] == full["accepted_slo_misses"] == 0
            assert spec["tokens"] == full["tokens"]
            assert spec["energy_j"] / spec["tokens"] <= full["energy_j"] / full["tokens"] * (1 + 1e-9)
            for i in spec_req:
                assert spec_req[i] <= full_req[i] * (1 + 1e-9), (seed, i)
            out.append([spec["energy_j"], full["energy_j"], spec["tokens_per_fused_step"]])
        return out

    _both(scenario)


def test_seeded_sweep_quoted_contracts_all_met():
    """Random classifier + decoder mixes on one shared clock, every decode
    contract admitted at its re-quoted minimum feasible deadline, the
    decoder speculating off a warm (or cold) calibrator: zero accepted-SLO
    misses; both packages, the same quotes and telemetry."""
    def mix(ns, seed, spec_window, warm):
        model, params, cfg = _model(ns, n_layers=4)
        cmodel, cparams, ccfg = _model(ns, "albert_edgebert", seed=0)
        rng = np.random.default_rng(seed)
        stats = ns.stats(seq_len=32)
        stats.n_layers = cfg.n_layers
        target = ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * 2.0
        arb = ns.dvfs.BatchedDVFSArbiter(ns.dvfs.LatencyAwareDVFSController(stats, target))
        thr = ns.probe(model, params, _prompts(cfg, (6, 5, 7, 4), seed=0), max_new_tokens=4, quantile=0.8,
                       **ns.probe_kw)
        dec = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), arbiter=arb,
                         exit_threshold=thr, spec_window=spec_window, threshold_schedule=ns.Schedule(thr),
                         **ns.dec_kw)
        cls = ns.Classifier(cmodel, cparams, batch_lanes=2, arbiter=arb, buckets=(16, 32), **ns.cls_kw)
        if warm:
            for i, p in enumerate(_prompts(cfg, (5, 6), seed=99)):
                dec.submit(ns.Request(uid=900 + i, tokens=p, max_new_tokens=4, deadline_s=target * 100))
            dec.run()
        n_cls, n_dec = int(rng.integers(2, 6)), int(rng.integers(2, 6))
        for i in range(n_cls):
            cls.submit(ns.Request(uid=i, tokens=rng.integers(4, ccfg.vocab_size, size=int(rng.integers(5, 30)))))
        ac = ns.Admission(dec, on_infeasible="requote", extra_wait_s=lambda: n_cls * target)
        decisions = []
        for i in range(n_dec):
            L = int(rng.integers(4, 9))
            req = ns.Request(uid=1000 + i, tokens=rng.integers(4, cfg.vocab_size, size=L).astype(np.int32),
                             max_new_tokens=int(rng.integers(2, 5)), deadline_s=1e-9)
            decisions.append(ac.submit(req))
        _drain_both(cls, dec)
        st = dec.telemetry()
        assert st["accepted_slo_misses"] == 0, (seed, spec_window, warm)
        assert all(d.action == "requoted" for d in decisions)
        for uid, req in dec.done.items():
            if req.deadline_s is not None and req.latency_s is not None:
                assert req.latency_s <= req.deadline_s * (1 + 1e-9), (seed, uid)
        return {"tel": st, "deadlines": [dec.done[u].deadline_s for u in sorted(dec.done)],
                "generated": [dec.done[u].generated for u in sorted(dec.done)]}

    def scenario(ns):
        return [mix(ns, seed, W, warm) for seed in (0, 1, 2) for W, warm in ((SPEC_W, False), (SPEC_W, True),
                                                                              (1, True))]

    _both(scenario)


def test_decoder_server_refuses_what_is_not_ported():
    model, params, cfg = _model(TORCH, n_layers=4)
    # replicas are served (test_torch_sharded_serving.py); a replica count
    # that disagrees with the device list is refused
    with pytest.raises(ValueError, match="replica"):
        TDecoder(model, params, replicas=3, devices=["cpu", "cpu"], device="cpu")
    with pytest.raises(ValueError, match="spec_window"):
        TDecoder(model, params, spec_window=2, device="cpu")
    cmodel, cparams, _ = _model(TORCH, "albert_edgebert", seed=0)
    with pytest.raises(ValueError, match="dense"):
        TDecoder(cmodel, cparams, device="cpu")


def test_serve_launcher_decoder_branch():
    stats = serve.main(["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--requests", "4",
                        "--max-new-tokens", "3"])
    assert stats["completed"] == 4 and stats["tokens"] == 12
    stats = serve.main(["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--requests", "3",
                        "--max-new-tokens", "2", "--threshold", "100.0"])
    assert stats["avg_token_exit_layer"] == 1.0


# ---------------------------------------------------------------------------
# test_admission.py: the decoder case
# ---------------------------------------------------------------------------


def test_decoder_checkpoint_restore_parity():
    """A preempted-then-restored decode generates the same tokens as an
    isolated single-request decode, with one decode and one prefill build;
    both packages, the same tokens."""
    out = {}
    for ns in (JAX, TORCH):
        model, params, cfg = _model(ns)
        prompts = _prompts(cfg, (6, 5, 7))

        def reference(p, max_new, max_seq, model=model, params=params):
            cache = model.init_cache(1, max_seq, **({"device": "cpu"} if ns is TORCH else {}))
            for t in range(len(p) - 1):
                _, cache = model.decode_step(params, cache, np.asarray([[int(p[t])]]), t)
            pos, cur, outs = len(p) - 1, int(p[-1]), []
            for _ in range(max_new):
                lg, cache = model.decode_step(params, cache, np.asarray([[cur]]), pos)
                cur = int(np.asarray(lg[0, -1]).argmax())
                outs.append(cur)
                pos += 1
            return outs

        srv = ns.Decoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, preempt=True,
                         **ns.dec_kw)
        for i, p in enumerate(prompts):
            srv.submit(ns.Request(uid=i, tokens=p, max_new_tokens=6))
        srv.step()
        srv.step()
        srv.submit(ns.Request(uid=99, tokens=prompts[0][:4], max_new_tokens=2, deadline_s=30.0))
        stats = srv.run()
        assert stats["preemptions"] >= 1
        assert stats["restored_steps_saved"] >= 1
        for i, p in enumerate(prompts):
            assert srv.done[i].generated == reference(p, 6, 32), i
        assert stats["decode_traces"] == 1 and stats["prefill_traces"] == 1
        out[ns.name] = srv
    assert_same_servers(out["jax"], out["torch"])


# ---------------------------------------------------------------------------
# test_arbiter_properties.py: the cross-engine cases (a classifier sharing
# one arbiter clock with decoder lanes)
# ---------------------------------------------------------------------------


def _cross_servers(ns):
    cmodel, cparams, ccfg = _model(ns, "albert_edgebert", seed=0)
    dmodel, dparams, dcfg = _model(ns)
    stats = ns.stats(seq_len=16)
    stats.n_layers = ccfg.n_layers
    ctrl = ns.dvfs.LatencyAwareDVFSController(stats, ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * 1.5)
    arb = ns.dvfs.BatchedDVFSArbiter(ctrl)
    dec = ns.Decoder(dmodel, dparams, batch_lanes=2, max_seq=32, buckets=(16,), arbiter=arb,
                     **({"device": "cpu"} if ns is TORCH else {}))
    cls = ns.Classifier(cmodel, cparams, batch_lanes=2, buckets=(16,), arbiter=arb, **ns.cls_kw)
    batch = SyntheticCLS(ccfg.vocab_size, 32, 8, num_classes=3, seed=0).batch(0)
    return arb, ctrl, dec, cls, batch


def _drain_both(cls, dec):
    while not (cls.sched.idle and dec.sched.idle):
        dec.step()
        cls.step()


def _both(scenario):
    out_j, out_t = scenario(JAX), scenario(TORCH)
    assert_same(out_j, out_t)


def test_accepted_classifier_slo_survives_crawling_decoder_lanes():
    def scenario(ns):
        arb, ctrl, dec, cls, batch = _cross_servers(ns)
        prompt = np.arange(1, 6, dtype=np.int32)
        slow = dec._cycles_for(16) * 12 / ctrl.table[0].freq_hz
        for i in range(2):
            dec.submit(ns.Request(uid=100 + i, tokens=prompt, max_new_tokens=10, deadline_s=slow * 4.0))
        dec.step()
        ac = ns.Admission(cls)
        xterm = ac._cross_engine_backlog_s()
        assert xterm > 0.0
        q = ac.quote(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=1e9))
        assert q.wait_s >= xterm
        q_old_deadline = (q.wait_s - xterm + q.service_s) * ac.headroom
        assert q_old_deadline < q.min_deadline_s
        d = ac.submit(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=q.min_deadline_s))
        assert d.admitted
        _drain_both(cls, dec)
        assert cls.telemetry()["accepted_slo_misses"] == 0
        assert dec.telemetry()["accepted_slo_misses"] == 0
        r = cls.done[0]
        assert r.retire_s - r.arrival_s <= r.deadline_s * (1 + 1e-9)
        assert r.retire_s - r.arrival_s > q_old_deadline
        return {"xterm": xterm, "quote": [q.wait_s, q.service_s, q.min_deadline_s],
                "retire_s": r.retire_s, "dec": dec.telemetry(), "cls": cls.telemetry(),
                "generated": [dec.done[u].generated for u in (100, 101)]}

    _both(scenario)


def test_old_pricing_counterexample_still_refuted():
    def scenario(ns):
        arb, ctrl, dec, cls, batch = _cross_servers(ns)
        prompt = np.arange(1, 6, dtype=np.int32)
        slow = dec._cycles_for(16) * 12 / ctrl.table[0].freq_hz
        for i in range(2):
            dec.submit(ns.Request(uid=100 + i, tokens=prompt, max_new_tokens=10, deadline_s=slow * 4.0))
        dec.step()
        ac = ns.Admission(cls)
        ac._cross_engine_backlog_s = lambda: 0.0     # old pricing
        q = ac.quote(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=1e9))
        d = ac.submit(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=q.min_deadline_s))
        assert d.admitted
        _drain_both(cls, dec)
        assert cls.telemetry()["accepted_slo_misses"] >= 1
        return {"quote": q.min_deadline_s, "cls": cls.telemetry(), "dec": dec.telemetry()}

    _both(scenario)


def test_tight_foreign_deadlines_no_longer_over_reject():
    def scenario(ns):
        arb, ctrl, dec, cls, batch = _cross_servers(ns)
        prompt = np.arange(1, 6, dtype=np.int32)
        fast = dec._cycles_for(16) * 12 / ctrl.max_op.freq_hz
        for i in range(2):
            dec.submit(ns.Request(uid=100 + i, tokens=prompt, max_new_tokens=10, deadline_s=fast * 2.0))
        dec.step()
        ac = ns.Admission(cls)
        x_new = ac._cross_engine_backlog_s()
        slow_hz = ctrl.table[0].freq_hz
        x_old = 0.0
        for key, clk in arb._lanes.items():
            if isinstance(key, tuple) and len(key) == 3 and key[0] == cls._sid:
                continue
            rem = (float(clk.pred_layers_remaining) if clk.pred_layers_remaining is not None
                   else max(float(ctrl.stats.n_layers - clk.depth), 0.0))
            x_old += rem * clk.cycles_per_layer / slow_hz
        assert x_new < x_old * 0.9, (x_new, x_old)
        q = ac.quote(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=1e9))
        old_min_deadline = (q.wait_s - x_new + x_old + q.service_s) * ac.headroom
        slo = (q.min_deadline_s + old_min_deadline) / 2.0
        assert q.min_deadline_s <= slo < old_min_deadline
        d = ac.submit(ns.Request(uid=0, tokens=batch["tokens"][0][:12], deadline_s=slo))
        assert d.admitted
        _drain_both(cls, dec)
        assert cls.telemetry()["accepted_slo_misses"] == 0
        r = cls.done[0]
        assert r.retire_s - r.arrival_s <= r.deadline_s * (1 + 1e-9)
        return {"x": [x_new, x_old], "slo": slo, "retire_s": r.retire_s, "cls": cls.telemetry(),
                "dec": dec.telemetry()}

    _both(scenario)
