"""Trace-driven workload replay, port against the JAX package: the
non-bench-history cases of test_workload.py (arrival processes, trace
generation, JSONL files, bounded-memory replay on a host-only engine, the
full-path replay through admission and the arbiter), then the multi-task
path the port's ``launch/replay.py`` drives: ``ResidencyRouterTarget`` over
about 200 ``mmpp_multitask`` events, four tasks with their own weights.

Each case runs the same inputs through ``repro`` and ``repro_torch`` (smoke
``albert_edgebert``, float32, JAX-initialised params carried over by
``bridge.params_from_numpy``; the port on the CPU, where its kernel route
runs the plain versions).  Events, arrival times and JSONL bytes are equal;
replay summaries agree on every integer field and on ``per_tier`` and
``per_task``, and on every float within rel 1e-9; per-request task and exit
layer are equal, and logits agree within 2e-4 (on the shipped config, a
request beyond it must be explained by activation-quantization flips at
AdaptivFloat rounding boundaries: ``test_residency_router_replay_matches_jax``
says how).  On the port alone, two same-seed replays give
``summaries_identical`` summaries.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.data.synthetic import SyntheticCLS
from repro.hwmodel.edgebert_accel import albert_layer_stats as j_stats
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving import engine as j_engine
from repro.serving import residency as j_res
from repro.serving import scheduler as j_sched
from repro.serving import workload as jw
from repro.serving.admission import AdmissionController as JAdmission
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.launch import replay
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving import engine as t_engine
from repro_torch.serving import scheduler as t_sched
from repro_torch.serving import workload as tw
from repro_torch.serving.admission import AdmissionController as TAdmission

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

JAX = SimpleNamespace(name="jax", wl=jw, sched=j_sched, engine=j_engine, dvfs=jdvfs, stats=j_stats,
                      smoke=j_smoke, build=j_build, AdmissionController=JAdmission, server_kw={})
TORCH = SimpleNamespace(name="torch", wl=tw, sched=t_sched, engine=t_engine, dvfs=tdvfs,
                        stats=t_stats, smoke=t_smoke, build=t_build, AdmissionController=TAdmission,
                        server_kw={"device": "cpu"})
LOGIT_ATOL = 2e-4
_JPARAMS = {}

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the smoke-size steps are many
    tiny ops, and under the suite's parallel workers torch's default pool
    per process oversubscribes the cores, so its ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def assert_same(a, b, path="out"):
    """Integers, flags, strings and None equal; floats within rel 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def _take(ns, proc, n, seed):
    it = proc.times(np.random.default_rng(seed))
    return np.array([t for _, t in zip(range(n), it)])


class TestTorchArrivalProcesses:
    def test_poisson_matches_jax(self):
        a = _take(TORCH, tw.PoissonArrivals(100.0), 20_000, seed=1)
        assert np.array_equal(a, _take(JAX, jw.PoissonArrivals(100.0), 20_000, seed=1))
        assert np.array_equal(a, _take(TORCH, tw.PoissonArrivals(100.0), 20_000, seed=1))
        assert not np.array_equal(a, _take(TORCH, tw.PoissonArrivals(100.0), 20_000, 2))
        assert np.all(np.diff(a) > 0)
        assert abs(len(a) / a[-1] - 100.0) / 100.0 < 0.05

    def test_mmpp_matches_jax(self):
        proc = tw.MMPPArrivals((50.0, 500.0), (2.0, 0.5))
        a = _take(TORCH, proc, 30_000, seed=2)
        assert np.array_equal(a, _take(JAX, jw.MMPPArrivals((50.0, 500.0), (2.0, 0.5)), 30_000, seed=2))
        assert np.all(np.diff(a) > 0)
        expect = proc.long_run_rate_hz
        assert abs(len(a) / a[-1] - expect) / expect < 0.15
        gaps = np.diff(a)
        assert float(np.var(gaps) / np.mean(gaps) ** 2) > 1.5      # burstier than Poisson

    def test_diurnal_matches_jax(self):
        a = _take(TORCH, tw.DiurnalArrivals(100.0, period_s=10.0, depth=0.6), 40_000, seed=3)
        assert np.array_equal(a, _take(JAX, jw.DiurnalArrivals(100.0, period_s=10.0, depth=0.6), 40_000, 3))
        assert np.all(np.diff(a) > 0)
        whole = a[a < 10.0 * int(a[-1] / 10.0)]
        assert abs(len(whole) / whole[-1] - 100.0) / 100.0 < 0.05
        phase = np.mod(whole, 10.0)
        assert np.sum(phase < 5.0) / np.sum(phase >= 5.0) > 1.3


def _mixed_config(ns, seed=7):
    w = ns.wl
    return w.WorkloadConfig(
        arrivals=w.PoissonArrivals(200.0), lengths=((16, 0.7), (32, 0.3)),
        tiers=(w.TierSpec("explicit", 0.35, 80.0), w.TierSpec("best_effort", 0.65)),
        tasks=(("mnli", 0.48), ("qqp", 0.24), ("sst2", 0.16), ("qnli", 0.12)), seed=seed)


def _events(ns, n, seed=7):
    return [vars(e) for e in ns.wl.generate_trace(_mixed_config(ns, seed), n, service_s=lambda L: 0.001 * L)]


class TestTorchTraceGeneration:
    def test_seeded_determinism_and_seed_sensitivity_matches_jax(self):
        a = _events(TORCH, 2000)
        assert a == _events(JAX, 2000) and a == _events(TORCH, 2000)
        assert a != _events(TORCH, 2000, seed=8)

    def test_mix_proportions_and_deadline_pricing_matches_jax(self):
        evs = _events(TORCH, 20_000, seed=7)
        assert evs == _events(JAX, 20_000, seed=7)
        n = len(evs)
        for tier, w in (("explicit", 0.35), ("best_effort", 0.65)):
            assert abs(sum(e["tier"] == tier for e in evs) / n - w) < 0.02
        for t, w in _mixed_config(TORCH).tasks:
            assert abs(sum(e["task"] == t for e in evs) / n - w) < 0.02, t
        for e in evs[:500]:
            bucket = 16 if e["length"] <= 16 else 32
            assert max(4, bucket // 2 + 1) <= e["length"] <= bucket
            if e["tier"] == "explicit":
                assert e["deadline_s"] == pytest.approx(80.0 * 0.001 * e["length"])
            else:
                assert e["deadline_s"] is None

    def test_jsonl_either_side_loads_the_other_matches_jax(self, tmp_path):
        evs = {ns.name: list(ns.wl.generate_trace(_mixed_config(ns), 500, service_s=lambda L: 0.001 * L))
               for ns in (JAX, TORCH)}
        paths = {name: str(tmp_path / f"{name}.jsonl") for name in evs}
        for ns in (JAX, TORCH):
            assert ns.wl.save_trace(paths[ns.name], evs[ns.name]) == 500
        assert Path(paths["jax"]).read_bytes() == Path(paths["torch"]).read_bytes()
        want = [vars(e) for e in evs["jax"]]
        for ns in (JAX, TORCH):
            for name in paths:
                assert [vars(e) for e in ns.wl.load_trace(paths[name])] == want, (ns.name, name)


class _NullEngine:
    """Host-only engine: every request retires after one fused step."""

    def bucket_key(self, req):
        return len(req.tokens)

    def bucket_begin(self, bucket):
        pass

    def lane_load(self, bucket, lane, req):
        pass

    def lanes_step(self, bucket, active):
        return None

    def lane_advance(self, bucket, lane, req, out, depth):
        return True

    def lane_finish(self, bucket, lane, req, depth):
        pass

    def bucket_end(self, bucket):
        pass


def _stub_replay(ns, cfg_fn, n, lanes=4, **kw):
    sched = ns.sched.LaneScheduler(lanes, _NullEngine(), buckets=(8,))
    rep = ns.wl.TraceReplayer(ns.wl.AdmissionServerTarget(sched), vocab_size=64, **kw)
    return rep.replay(ns.wl.generate_trace(cfg_fn(ns), n, service_s=lambda L: 1.0)), sched


class TestTorchBoundedMemoryReplay:
    def test_hundred_thousand_requests_stay_bounded_matches_jax(self):
        """10^5 requests through the port's replay loop in bounded memory;
        the summary equals the JAX package's."""
        total, lanes = 100_000, 4

        def cfg(ns):
            w = ns.wl
            return w.WorkloadConfig(arrivals=w.PoissonArrivals(3.0), lengths=((8, 1.0),),
                                    tiers=(w.TierSpec("explicit", 0.3, 40.0), w.TierSpec("best_effort", 0.7)),
                                    seed=11)

        s, sched = _stub_replay(TORCH, cfg, total, lanes, token_seed=0)
        assert s["requests"] == s["submitted"] == s["completed"] == total
        assert s["completed"] + s["rejected"] + s["shed"] == total
        assert s["peak_done"] <= lanes and s["peak_outstanding"] < total // 100
        assert len(sched.done) == 0 and len(sched._delays.buf) <= sched._delays.cap
        assert s["queue_delay_steps_p99"] >= s["queue_delay_steps_p95"] >= s["queue_delay_steps_p50"] >= 0.0
        assert s["modeled_span_s"] > 0.0
        assert s["per_tier"]["explicit"]["completed"] > 0 and s["per_tier"]["best_effort"]["completed"] > 0
        assert_same(_stub_replay(JAX, cfg, total, lanes, token_seed=0)[0], s)

    def test_replay_is_deterministic_on_stub_matches_jax(self):
        def cfg(ns):
            w = ns.wl
            return w.WorkloadConfig(arrivals=w.MMPPArrivals((1.0, 10.0), (30.0, 6.0)), lengths=((8, 1.0),),
                                    tiers=(w.TierSpec("best_effort", 1.0),), seed=5)

        s = _stub_replay(TORCH, cfg, 20_000)[0]
        assert tw.summaries_identical(s, _stub_replay(TORCH, cfg, 20_000)[0])
        assert_same(_stub_replay(JAX, cfg, 20_000)[0], s)


def _smoke(ns):
    return dataclasses.replace(ns.smoke("albert_edgebert"), dtype="float32", remat_policy="none")


def _params(ns, seed=0):
    if seed not in _JPARAMS:
        _JPARAMS[seed] = j_build(_smoke(JAX)).init_params(jax.random.PRNGKey(seed))
    p = _JPARAMS[seed]
    return p if ns is JAX else params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


class TestTorchFullPathReplay:
    """One server through admission, scheduler and the DVFS arbiter."""

    def _run(self, ns, n=300, seed=0):
        cfg = _smoke(ns)
        buckets = (16, 32)
        stats = ns.stats(seq_len=max(buckets))
        stats.n_layers = cfg.n_layers
        target = ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * 1.5
        ctrl = ns.dvfs.LatencyAwareDVFSController(stats, target)
        svc = lambda L: cfg.n_layers * ctrl.cycles_for_seq_len(16 if L <= 16 else 32) / ctrl.max_op.freq_hz
        w = ns.wl
        wl = w.WorkloadConfig(
            arrivals=w.MMPPArrivals((0.35 * 4 / svc(32), 1.5 * 4 / svc(32)), (0.08, 0.02)),
            lengths=((16, 0.6), (32, 0.4)),
            tiers=(w.TierSpec("explicit", 0.4, 80.0), w.TierSpec("best_effort", 0.6)), seed=seed)
        server = ns.engine.ClassifierServer(
            ns.build(cfg), _params(ns), batch_lanes=4, buckets=buckets,
            arbiter=ns.dvfs.BatchedDVFSArbiter(ns.dvfs.LatencyAwareDVFSController(stats, target)),
            **ns.server_kw)
        target_ = w.AdmissionServerTarget(server, ns.AdmissionController(server, max_best_effort_queue=16))
        rep = w.TraceReplayer(target_, vocab_size=cfg.vocab_size, token_seed=seed)
        return rep.replay(w.generate_trace(wl, n, service_s=svc))

    def test_zero_extra_builds_deterministic_and_conserved_matches_jax(self):
        s1 = self._run(TORCH)
        assert s1["max_traces_per_bucket_replica"] == 1 and s1["step_traces"] == 2
        assert s1["completed"] + s1["rejected"] + s1["shed"] == s1["submitted"] == s1["requests"]
        assert s1["accepted_slo_misses"] == 0
        assert s1["completed_best_effort"] > 0 and s1["energy_j"] > 0.0
        assert tw.summaries_identical(s1, self._run(TORCH))
        assert not tw.summaries_identical(s1, self._run(TORCH, seed=1))
        assert_same(self._run(JAX), s1)


def test_idle_gap_moves_the_arbiter_clock():
    """``_advance_scheduler_idle`` reads ``server.arbiters``: an idle gap
    moves the shared arbiter clock, and the scheduler syncs to it (without
    the list only the scheduler clock would move and every quote after the
    gap would price from a stale arbiter)."""
    cfg = _smoke(TORCH)
    stats = t_stats(seq_len=32)
    arb = tdvfs.BatchedDVFSArbiter(tdvfs.LatencyAwareDVFSController(stats, 1.0))
    srv = t_engine.ClassifierServer(t_build(cfg), _params(TORCH), batch_lanes=2, buckets=(32,),
                                    arbiter=arb, device="cpu")
    assert srv.arbiters == [arb]
    tw.AdmissionServerTarget(srv).advance_idle_to(0.25)
    assert arb.now_s == 0.25 and srv.sched.now_s == 0.25 and srv.clock_s() == 0.25


# ---------------------------------------------------------------------------
# the multi-task path: per-task admission over a ResidencyRouter
# ---------------------------------------------------------------------------

N_EVENTS = 200


class _JaxRecording(jw.ResidencyRouterTarget):
    """The JAX package's ResidencyRouterTarget keeping what the port's
    ``RecordingRouterTarget`` keeps (task and exit layer in ``record``,
    ``logits``), and each request's tokens."""

    def __init__(self, router, **kw):
        super().__init__(router, **kw)
        self.record, self.logits, self.tokens = {}, {}, {}

    def poll(self):
        out = []
        for name, srv in self.router.tasks.items():
            got = srv.poll()
            for r in got:
                self.record[r.uid] = (name, r.exit_layer)
                self.logits[r.uid] = np.asarray(r.result, np.float64)
                self.tokens[r.uid] = np.asarray(r.tokens)
            out.extend(got)
        return out


def _task_params(ns, tasks):
    by_task = {t: _params(ns, replay.TASK_SEED + i) for i, t in enumerate(tasks)}
    return by_task[tasks[0]]["embed"], by_task


@pytest.fixture(scope="module")
def harness():
    from benchmarks.harness import scenarios

    return scenarios


def _jax_calibrate(cfg, params, buckets):
    """The JAX harness's controller set-up (bench_batched_dvfs._setup and
    run_harness._model_and_controller), on the given params."""
    data = SyntheticCLS(cfg.vocab_size, 32, 16, num_classes=3, seed=0)
    out = j_build(cfg).apply_train(params, {"tokens": jnp.asarray(data.batch(0)["tokens"])})
    thr = float(np.quantile(np.asarray(out.all_entropies[0]), 0.3))
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=thr))
    stats = j_stats(seq_len=max(buckets))
    stats.n_layers = cfg.n_layers
    target = jdvfs.no_early_exit_baseline(stats)["latency_s"] * replay.TARGET_MULT
    pred = jdvfs.calibrate_predictor(j_build(cfg), params, [data.batch(100 + i) for i in range(2)],
                                     quantile=1.0)
    return cfg, lambda: jdvfs.LatencyAwareDVFSController(stats, target, predictor=pred)


def _jax_target(harness, cfg, embed, by_task, ctrl_factory):
    """The residency branch of the JAX harness's build_target, with each
    task's own params."""
    spec = harness.SCENARIOS["mmpp_multitask"]
    buckets = tuple(spec["buckets"])
    tasks = [t for t, _ in spec["tasks"]]
    svc = harness.full_depth_service_s(ctrl_factory(), cfg.n_layers, buckets)
    margin = float(spec["affinity_margin_services"]) * svc(max(buckets))
    deps = {t: j_res.TaskDeployment(t, n_params=11e6, pruning_occupancy=0.4, spans=(0,) * 6 + (64,) * 6)
            for t in tasks}
    res = j_res.TaskResidencyManager(deps, sram_bytes=float(spec["sram_tasks"])
                                     * deps[tasks[0]].storage()["total_bytes"])
    router = j_res.ResidencyRouter(
        j_build(cfg), embed, by_task, residency=res, deployments=deps,
        task_policy=j_res.TaskAffinityPolicy(preempt_slack_s=margin),
        arbiter=jdvfs.BatchedDVFSArbiter(ctrl_factory()), buckets=buckets, batch_lanes=replay.LANES)
    return _JaxRecording(router, admission_kwargs={
        "max_best_effort_queue": replay.BEST_EFFORT_QUEUE, "headroom": float(spec["admission_headroom"])})


def _act_quant(cfg, on):
    return cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, quantize_activations=on))


def _port_stack(act_quant=True):
    """``launch/replay.py``'s set-up on the JAX-initialised task params."""
    tasks = [t for t, _ in replay.MMPP_MULTITASK["tasks"]]
    return replay.build_stack(_act_quant(replay.replay_config(smoke=True), act_quant), tasks,
                              params=_task_params(TORCH, tasks))


@pytest.fixture(scope="module")
def jax_replays(harness):
    """The JAX package's replay of the same events, per activation-quant
    setting: (summary, recording target, config), built once."""
    cache = {}

    def get(act_quant):
        if act_quant not in cache:
            spec = harness.SCENARIOS["mmpp_multitask"]
            tasks = [t for t, _ in spec["tasks"]]
            embed, by_task = _task_params(JAX, tasks)
            cfg, ctrl = _jax_calibrate(_act_quant(_smoke(JAX), act_quant), by_task[tasks[0]], (16, 32))
            target = _jax_target(harness, cfg, embed, by_task, ctrl)
            wl = harness.build_workload(spec, ctrl=ctrl(), n_layers=cfg.n_layers, lanes=replay.LANES, seed=0)
            svc = harness.full_depth_service_s(ctrl(), cfg.n_layers, (16, 32))
            summary = jw.TraceReplayer(target, vocab_size=cfg.vocab_size, token_seed=0).replay(
                jw.generate_trace(wl, N_EVENTS, service_s=svc))
            cache[act_quant] = (summary, target, cfg, by_task)
        return cache[act_quant]

    return get


def test_launcher_spec_is_the_harness_scenario(harness):
    """``launch/replay.py`` keeps a copy of the harness's mmpp_multitask
    spec and conversion: the same spec (less its description) and the same
    events from the same controller."""
    spec = dict(harness.SCENARIOS["mmpp_multitask"])
    spec.pop("description")
    assert replay.MMPP_MULTITASK == spec
    cfg = _smoke(JAX)
    ctrls = [ns.dvfs.LatencyAwareDVFSController(ns.stats(seq_len=32), 1e-3) for ns in (JAX, TORCH)]
    wls = [harness.build_workload(spec, ctrl=ctrls[0], n_layers=cfg.n_layers, lanes=4, seed=3),
           replay.build_workload(spec, ctrl=ctrls[1], n_layers=cfg.n_layers, lanes=4, seed=3)]
    svcs = [harness.full_depth_service_s(ctrls[0], cfg.n_layers, (16, 32)),
            replay.full_depth_service_s(ctrls[1], cfg.n_layers, (16, 32))]
    assert harness.capacity_rps(ctrls[0], 12, 4, ((16, 0.7), (32, 0.3))) == \
        replay.capacity_rps(ctrls[1], 12, 4, ((16, 0.7), (32, 0.3)))
    evs = [[vars(e) for e in mod.generate_trace(w, 300, service_s=s)]
           for mod, w, s in ((jw, wls[0], svcs[0]), (tw, wls[1], svcs[1]))]
    assert evs[0] == evs[1]


PRE_QUANT_ATOL = 1e-5


def _flips_behind(uid, target_j, cfg_j, jparams, tparams, use_kernels):
    """Teacher-forced on the JAX package's state, layer by layer up to the
    request's exit: the one-lane serving step before activation
    quantization in both packages (within PRE_QUANT_ATOL), then each
    package's AdaptivFloat quantization of its own result.  The lane's bias
    must be equal, and every quantized element that differs must be one
    grid step between neighbouring values whose midpoint lies within the
    pre-quantization difference of the JAX value: the two sums straddle a
    rounding boundary.  Returns the number of such flips."""
    from chip_smoke import af_next_step
    from repro.core.adaptivfloat import AFFormat as JAFFormat
    from repro.core.adaptivfloat import af_quantize as j_af_quantize
    from repro_torch.core.adaptivfloat import AFFormat as TAFFormat
    from repro_torch.kernels.adaptivfloat_k import quantize_groups

    task, exit_layer = target_j.record[uid]
    toks = target_j.tokens[uid]
    n = len(toks)
    S = next(b for b in replay.MMPP_MULTITASK["buckets"] if b >= n)
    padded = np.zeros((1, S), np.int32)
    padded[0, :n] = toks
    q = cfg_j.edgebert.quant
    jfmt, tfmt = JAFFormat(q.n_bits, q.n_exp), TAFFormat(q.n_bits, q.n_exp)
    jm, jm0 = j_build(cfg_j), j_build(_act_quant(cfg_j, False))
    tm0 = t_build(_act_quant(_smoke(TORCH), False))
    jp, tp = jparams[task], tparams[task]
    kv = jnp.asarray([n], jnp.int32)
    span_j, span_t = jm._span_for_layer(jp, 0), tm0._span_for_layer(tp, 0)
    valid = (np.arange(S) < n)[None, :, None]
    h = jm.embed(jp, jnp.asarray(padded))
    flips = 0
    for layer in range(exit_layer):
        pre_j = jax.vmap(lambda h_l, k: jm0._dense_layer_step(jp["layer"], h_l[None], causal=False, span_z=span_j,
                                                               kv_len=k)[0][0])(h, kv)
        pre_t = tm0._dense_layer_step(tp["layer"], torch.from_numpy(np.array(h)), causal=False, span_z=span_t,
                                      kv_len=torch.tensor([n], dtype=torch.int32), use_kernels=use_kernels,
                                      per_lane=True)
        qj = torch.from_numpy(np.array(j_af_quantize(pre_j[0], jfmt)))[None]
        qt, et = quantize_groups(pre_t.reshape(S, -1).contiguous(), S, fmt=tfmt)
        qt = qt.reshape(qj.shape)
        pre_c = torch.from_numpy(np.array(pre_j))
        pre_err = (pre_t - pre_c).abs()
        assert float(pre_err[torch.from_numpy(np.broadcast_to(valid, pre_err.shape))].max()) <= PRE_QUANT_ATOL, \
            (uid, layer)
        _, ej = quantize_groups(pre_c.reshape(S, -1).contiguous(), S, fmt=tfmt)
        assert torch.equal(et, ej), (uid, layer)
        flip = (qt != qj) & torch.from_numpy(valid)
        lo = torch.minimum(qt.abs(), qj.abs())
        step = af_next_step(lo, ej.float(), tfmt)
        one_step = (qt * qj >= 0) & (lo + step == torch.maximum(qt.abs(), qj.abs()))
        at_boundary = (pre_c - (qt + qj) / 2).abs() <= pre_err + 1e-7 * pre_c.abs()
        assert bool((one_step & at_boundary)[flip].all()), (uid, layer)
        flips += int(flip.sum())
        h = jm._maybe_actquant(pre_j)                  # the JAX server's state
    return flips


@pytest.mark.parametrize("act_quant", [True, False], ids=["shipped", "no_act_quant"])
def test_residency_router_replay_matches_jax(jax_replays, act_quant):
    """About 200 mmpp_multitask events, four tasks with their own encoder
    and head weights (seeds 10-13) behind one embedding, on the port's
    kernel route (plain versions on the CPU): per-request task and exit
    layer equal, the summaries agree, and every request's logits agree
    within 2e-4.

    The one exemption, on the shipped config: a last-ulp difference between
    two float32 sums that straddle an AdaptivFloat rounding boundary becomes
    one whole quantum, carried to the logits (here one request of the 200
    differs by 0.0155).  A request beyond 2e-4 passes only if
    ``_flips_behind`` finds such flips on its own path, every one of them a
    single grid step at a boundary with the layer step before quantization
    within 1e-5; at most one request in 200 may need it."""
    st = _port_stack(act_quant)
    target_t = replay.build_target(st.cfg, st.embed, st.by_task, st.ctrl_factory, device="cpu",
                                   target_cls=replay.RecordingRouterTarget)
    s_t = tw.TraceReplayer(target_t, vocab_size=st.cfg.vocab_size, token_seed=0).replay(
        tw.generate_trace(st.wl, N_EVENTS, service_s=st.svc))
    s_j, target_j, cfg_j, jparams = jax_replays(act_quant)
    assert st.cfg.edgebert.early_exit.entropy_threshold == pytest.approx(
        cfg_j.edgebert.early_exit.entropy_threshold, abs=1e-6)

    assert_same(s_j, s_t)
    assert s_t["completed"] + s_t["rejected"] + s_t["shed"] == s_t["submitted"] == N_EVENTS
    assert s_t["max_traces_per_bucket_replica"] <= 1 and s_t["task_swaps"] > 0
    assert len(s_t["per_task"]) == 4 and len({e for _, e in target_t.record.values()}) > 1
    assert target_j.record == target_t.record
    beyond = [uid for uid in target_j.logits
              if not np.allclose(target_t.logits[uid], target_j.logits[uid], atol=LOGIT_ATOL, rtol=0)]
    assert len(beyond) <= max(1, s_t["completed"] // 200) and (act_quant or not beyond), beyond
    use_kernels = next(iter(target_t.router.tasks.values())).use_kernels
    for uid in beyond:
        assert _flips_behind(uid, target_j, cfg_j, jparams, st.by_task, use_kernels) > 0, uid
    assert_same({"switches": target_j.router.task_switches, "steps": target_j.router.task_steps},
                {"switches": target_t.router.task_switches, "steps": target_t.router.task_steps})


def test_residency_router_replay_deterministic_and_shares_the_embedding():
    """Two same-seed replays on fresh port stacks: ``summaries_identical``,
    the same per-request record (``RecordingRouterTarget``); every task
    server holds the router's one embedding table."""
    st = _port_stack()
    runs = []
    for _ in range(2):
        target = replay.build_target(st.cfg, st.embed, st.by_task, st.ctrl_factory, device="cpu",
                                     target_cls=replay.RecordingRouterTarget)
        runs.append((tw.TraceReplayer(target, vocab_size=st.cfg.vocab_size, token_seed=0).replay(
            tw.generate_trace(st.wl, 120, service_s=st.svc)), target))
    (s1, t1), (s2, t2) = runs
    assert tw.summaries_identical(s1, s2) and t1.record == t2.record
    assert t1.first_entropy == t2.first_entropy
    assert all(np.array_equal(t1.logits[u], t2.logits[u]) for u in t1.logits)
    assert len(t1.record) == s1["completed"] and replay.fused_steps(t1) == replay.fused_steps(t2) > 0
    ptrs = {srv.params["embed"]["tok"].data_ptr() for srv in t1.router.tasks.values()}
    assert ptrs == {t1.router.shared_embed["tok"].data_ptr()}
    assert len({srv.params["layer"]["mlp"]["w_up"].data_ptr() for srv in t1.router.tasks.values()}) == 4


def test_replay_launcher_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.replay", "--smoke", "--device", "cpu",
         "--requests", "64", "--verify-determinism"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "replayed 64 of 64 saved events on cpu" in proc.stdout
    assert "bit-identical summary" in proc.stdout
