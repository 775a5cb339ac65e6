"""Admission control, port against the JAX package: the classifier cases of
test_admission.py and the arbiter cases of test_arbiter_properties.py.

Each case runs one scenario through ``repro`` and through ``repro_torch``
(smoke ``albert_edgebert``, float32, JAX-initialised params carried over by
``bridge.params_from_numpy``; the port's servers on the CPU, where its
kernel route runs the plain versions), makes the reference test's
assertions on both sides, and compares what both did: quotes, decisions,
re-quoted deadlines, per-request exit layers and modeled clock stamps, and
telemetry.  Integers, flags and strings are equal; floats agree within
rel 1e-9 (the same Python arithmetic on the same modeled quantities).

The decoder cases (``test_decoder_checkpoint_restore_parity`` and the
cross-engine regressions, which need a ``DecoderServer``) are in
test_torch_decoder_server.py.
"""
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.configs.base import get_smoke_config as j_smoke
from repro.data.synthetic import SyntheticCLS
from repro.hwmodel.edgebert_accel import albert_layer_stats as j_stats
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving.admission import AdmissionController as JAdmission
from repro.serving.engine import ClassifierServer as JServer
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving.admission import AdmissionController as TAdmission
from repro_torch.serving.engine import ClassifierServer as TServer
from repro_torch.serving.engine import Request as TRequest

JAX = SimpleNamespace(name="jax", smoke=j_smoke, build=j_build, Server=JServer, Request=JRequest,
                      AdmissionController=JAdmission, dvfs=jdvfs, stats=j_stats, server_kw={})
TORCH = SimpleNamespace(name="torch", smoke=t_smoke, build=t_build, Server=TServer,
                        Request=TRequest, AdmissionController=TAdmission, dvfs=tdvfs,
                        stats=t_stats, server_kw={"device": "cpu"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the smoke-size steps are many
    tiny ops, and under the suite's parallel workers torch's default pool
    per process oversubscribes the cores, so its ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REQ_FIELDS = ("uid", "exit_layer", "bucket", "deadline_s", "quoted_deadline_s", "preempted",
              "shed", "ckpt_depth", "arrival_step", "first_compute_step", "retire_step",
              "arrival_s", "admit_s", "retire_s", "energy_j", "latency_s", "op_vdd", "op_freq_hz")

_JPARAMS = {}


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
        assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario):
    """Run ``scenario(ns)`` on the JAX package and on the port; the two
    observation trees must agree."""
    out_j, out_t = scenario(JAX), scenario(TORCH)
    assert_same(out_j, out_t)
    return out_j, out_t


def _albert(ns, threshold=1e-9):
    cfg = dataclasses.replace(ns.smoke("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                           entropy_threshold=threshold))
    if "p" not in _JPARAMS:
        _JPARAMS["p"] = j_build(cfg).init_params(jax.random.PRNGKey(0))
    params = _JPARAMS["p"]
    if ns is TORCH:
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return ns.build(cfg), params, cfg


def _server(ns, model, params, **kw):
    return ns.Server(model, params, **ns.server_kw, **kw)


def _controller(ns, cfg, mult):
    stats = ns.stats(seq_len=16)
    stats.n_layers = cfg.n_layers
    return ns.dvfs.LatencyAwareDVFSController(stats, ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * mult)


def _tokens(cfg, n=8, seed=0):
    return SyntheticCLS(cfg.vocab_size, 32, n, num_classes=3, seed=seed).batch(0)["tokens"]


def _req(r):
    return {f: getattr(r, f) for f in REQ_FIELDS} | {"trace_len": len(r.entropy_trace)}


def _quote(q):
    return None if q is None else dict(vars(q))


def _dec(d):
    return {"admitted": d.admitted, "action": d.action, "bucket": d.bucket, "quote": _quote(d.quote),
            "shed": [r.uid for r in d.shed]}


def _done(srv):
    return {uid: _req(r) for uid, r in sorted(srv.done.items())}


class TestTorchFeasibilityQuote:
    def test_infeasible_slo_rejected_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            d = ns.AdmissionController(srv).submit(ns.Request(uid=0, tokens=tok[0][:12], deadline_s=1.0))
            assert not d.admitted and d.action == "rejected"
            assert d.quote.min_deadline_s >= cfg.n_layers and not d.quote.feasible
            assert srv.pending == 0 and srv.sched.idle
            assert srv.telemetry()["rejected"] == 1
            return {"decision": _dec(d), "telemetry": srv.telemetry()}

        both(run)

    def test_quote_honored_on_resubmission_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            ac = ns.AdmissionController(srv)
            d = ac.submit(ns.Request(uid=0, tokens=tok[0][:12], deadline_s=1.0))
            d2 = ac.submit(ns.Request(uid=1, tokens=tok[0][:12], deadline_s=d.quote.min_deadline_s))
            assert d2.admitted and d2.action == "accepted"
            srv.run()
            r = srv.done[1]
            assert r.retire_step - r.arrival_step <= r.deadline_s
            return {"decisions": [_dec(d), _dec(d2)], "done": _done(srv), "telemetry": srv.telemetry()}

        both(run)

    def test_backlog_inflates_the_quote_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=1, buckets=(16,))
            ac = ns.AdmissionController(srv)
            q0 = ac.quote(ns.Request(uid=0, tokens=tok[0][:12], deadline_s=1.0))
            d = ac.submit(ns.Request(uid=1, tokens=tok[1][:12], deadline_s=q0.min_deadline_s))
            q1 = ac.quote(ns.Request(uid=2, tokens=tok[2][:12], deadline_s=1.0))
            assert q1.min_deadline_s > q0.min_deadline_s and q1.wait_s > q0.wait_s
            assert q1.wait_s == pytest.approx(q0.min_deadline_s)
            return {"q0": _quote(q0), "q1": _quote(q1), "decision": _dec(d)}

        both(run)

    def test_requote_mode_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            ac = ns.AdmissionController(srv, on_infeasible="requote")
            d = ac.submit(ns.Request(uid=0, tokens=tok[0][:12], deadline_s=1.0))
            assert d.admitted and d.action == "requoted"
            req = next(iter(srv.sched.queues[16]))
            assert req.quoted_deadline_s == 1.0
            assert req.deadline_s == pytest.approx(d.quote.min_deadline_s)
            srv.run()
            assert srv.telemetry()["requoted"] == 1
            r = srv.done[0]
            assert r.retire_step - r.arrival_step <= r.deadline_s
            return {"decision": _dec(d), "done": _done(srv), "telemetry": srv.telemetry()}

        out_j, _ = both(run)
        assert out_j["done"][0]["quoted_deadline_s"] == 1.0

    def test_arbiter_quote_prices_bucket_cycles_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            ctrl = _controller(ns, cfg, 2.0)
            arb = ns.dvfs.BatchedDVFSArbiter(ctrl)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,), arbiter=arb)
            q = ns.AdmissionController(srv, headroom=1.0).quote(
                ns.Request(uid=0, tokens=_tokens(cfg)[0][:12], deadline_s=1.0))
            floor = cfg.n_layers * ctrl.cycles_for_seq_len(16) / ctrl.max_op.freq_hz
            assert q.service_s >= floor
            assert q.service_s == pytest.approx(
                arb.min_latency_quote(cfg.n_layers, cycles_per_layer=ctrl.cycles_for_seq_len(16)))
            assert srv.arbiters == [arb] and srv.lanes_per_replica == 2
            return {"quote": _quote(q), "floor": floor}

        both(run)

    def test_queued_contract_claims_first_freed_lane_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=1, buckets=(16,))
            ac = ns.AdmissionController(srv)
            srv.submit(ns.Request(uid=0, tokens=tok[0][:12]))
            srv.step()
            q_empty = ac.quote(ns.Request(uid=90, tokens=tok[1][:12], deadline_s=1.0))
            d1 = ac.submit(ns.Request(uid=1, tokens=tok[1][:12], deadline_s=q_empty.min_deadline_s))
            assert d1.admitted
            q2 = ac.quote(ns.Request(uid=2, tokens=tok[2][:12], deadline_s=1.0))
            assert q2.wait_s > q_empty.wait_s
            assert q2.wait_s >= q_empty.min_deadline_s - srv.sched.now_s - 1e-9
            d2 = ac.submit(ns.Request(uid=2, tokens=tok[2][:12], deadline_s=q2.min_deadline_s))
            assert d2.admitted
            srv.run()
            for uid in (1, 2):
                r = srv.done[uid]
                assert r.retire_step - r.arrival_step <= r.deadline_s, uid
            return {"quotes": [_quote(q_empty), _quote(q2)], "decisions": [_dec(d1), _dec(d2)],
                    "done": _done(srv)}

        both(run)

    def test_shared_arbiter_syncs_scheduler_clocks_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            ctrl = _controller(ns, cfg, 1.5)
            arb = ns.dvfs.BatchedDVFSArbiter(ctrl)
            s1 = _server(ns, model, params, batch_lanes=2, buckets=(16,), arbiter=arb)
            s2 = _server(ns, model, params, batch_lanes=2, buckets=(16,), arbiter=arb)
            for i in range(2):
                s1.submit(ns.Request(uid=i, tokens=tok[i][:12]))
                s2.submit(ns.Request(uid=10 + i, tokens=tok[2 + i][:12]))
            clocks = []
            for s in (s1, s2, s1, s2, s1):
                s.step()
                assert s.sched.now_s == pytest.approx(arb.now_s)
                clocks.append(arb.now_s)
            late = ns.Request(uid=50, tokens=tok[5][:12], deadline_s=ctrl.target_latency_s)
            s2.submit(late)
            assert late.arrival_s == pytest.approx(arb.now_s)
            return {"clocks": clocks, "late": _req(late)}

        both(run)

    def test_best_effort_always_admitted_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            d = ns.AdmissionController(srv).submit(ns.Request(uid=0, tokens=_tokens(cfg)[0][:12]))
            assert d.admitted and d.quote is None and d.shed == []
            return _dec(d)

        both(run)


class TestTorchLoadShedding:
    def test_bounded_queue_drops_oldest_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            ac = ns.AdmissionController(srv, max_best_effort_queue=2)
            shed = []
            for i in range(6):
                shed += ac.submit(ns.Request(uid=i, tokens=tok[i][:12])).shed
            assert [r.uid for r in shed] == [0, 1, 2, 3] and all(r.shed for r in shed)
            srv.run()
            assert sorted(srv.done) == [4, 5]
            st = srv.telemetry()
            assert st["shed"] == 4 and st["sentences"] == 2
            return {"shed": [_req(r) for r in shed], "done": _done(srv), "telemetry": st}

        both(run)

    def test_explicit_slo_never_shed_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            ac = ns.AdmissionController(srv, max_best_effort_queue=1)
            d = ac.submit(ns.Request(uid=100, tokens=tok[0][:12], deadline_s=float(cfg.n_layers * 4)))
            for i in range(4):
                ac.submit(ns.Request(uid=i, tokens=tok[i][:12]))
            srv.run()
            assert 100 in srv.done and srv.telemetry()["shed"] == 3
            return {"decision": _dec(d), "done": _done(srv), "telemetry": srv.telemetry()}

        both(run)

    def test_checkpointed_request_never_shed_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=1, buckets=(16,), preempt=True)
            ac = ns.AdmissionController(srv, max_best_effort_queue=1)
            ac.submit(ns.Request(uid=0, tokens=tok[0][:12]))
            srv.step()
            ac.submit(ns.Request(uid=99, tokens=tok[1][:12], deadline_s=float(cfg.n_layers * 6)))
            srv.step()
            assert srv.telemetry()["preemptions"] == 1
            d = ac.submit(ns.Request(uid=1, tokens=tok[2][:12]))
            d2 = ac.submit(ns.Request(uid=2, tokens=tok[3][:12]))
            assert d.shed == [] and [r.uid for r in d2.shed] == [1]
            srv.run()
            assert 0 in srv.done and 99 in srv.done
            return {"decisions": [_dec(d), _dec(d2)], "done": _done(srv), "telemetry": srv.telemetry()}

        both(run)


class TestTorchPreemption:
    def test_classifier_checkpoint_restore_matches_jax(self):
        """A preempted-then-restored sentence gives the same logits (bit for
        bit) and exit as an uninterrupted run on each side, with one step
        build per bucket; the two packages agree on the schedule."""
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,), preempt=True)
            ref = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            for s in (srv, ref):
                for i in range(3):
                    s.submit(ns.Request(uid=i, tokens=tok[i][:12]))
            srv.step()
            srv.step()
            srv.submit(ns.Request(uid=99, tokens=tok[4][:12], deadline_s=float(cfg.n_layers + 3)))
            while srv.step() is not None:
                pass
            while ref.step() is not None:
                pass
            st, st_ref = srv.telemetry(), ref.telemetry()
            assert st["preemptions"] >= 1 and st["restored_steps_saved"] >= 1
            assert [i for i in range(3) if srv.done[i].preempted], "scenario must preempt a lane"
            for i in range(3):
                assert srv.done[i].exit_layer == ref.done[i].exit_layer, i
                assert np.array_equal(np.asarray(srv.done[i].result), np.asarray(ref.done[i].result)), i
            assert st["step_traces"] == st_ref["step_traces"] == 1
            assert st["insert_traces"] == st_ref["insert_traces"] == 1
            return {"done": _done(srv), "telemetry": st}

        both(run)

    def test_preemption_bounds_explicit_wait_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            outcomes = {}
            for preempt in (True, False):
                srv = _server(ns, model, params, batch_lanes=2, buckets=(16,), preempt=preempt)
                for i in range(4):
                    srv.submit(ns.Request(uid=i, tokens=tok[i][:12]))
                srv.step()
                srv.submit(ns.Request(uid=99, tokens=tok[5][:12], deadline_s=float(cfg.n_layers + 2)))
                while srv.step() is not None:
                    pass
                r = srv.done[99]
                outcomes[preempt] = r.first_compute_step - r.arrival_step
            assert outcomes[True] == 0 and outcomes[False] >= cfg.n_layers - 1
            return outcomes

        both(run)

    def test_preempted_lane_resumes_at_saved_depth_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=1, buckets=(16,), preempt=True)
            srv.submit(ns.Request(uid=0, tokens=tok[0][:12]))
            srv.step()
            srv.step()
            srv.submit(ns.Request(uid=99, tokens=tok[1][:12], deadline_s=float(cfg.n_layers * 4)))
            while srv.step() is not None:
                pass
            st = srv.telemetry()
            assert st["restored_steps_saved"] == 2
            r = srv.done[0]
            assert r.exit_layer == cfg.n_layers and len(r.entropy_trace) == cfg.n_layers
            return {"done": _done(srv), "telemetry": st}

        both(run)

    def test_arbiter_clock_survives_checkpoint_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            ctrl = _controller(ns, cfg, 2.0)
            arb = ns.dvfs.BatchedDVFSArbiter(ctrl)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,), arbiter=arb, preempt=True)
            for i in range(3):
                srv.submit(ns.Request(uid=i, tokens=tok[i][:12]))
            srv.step()
            srv.step()
            t_layer = ctrl.cycles_for_seq_len(16) / ctrl.max_op.freq_hz
            srv.submit(ns.Request(uid=99, tokens=tok[4][:12], deadline_s=t_layer * cfg.n_layers * 8))
            while srv.step() is not None:
                pass
            st = srv.telemetry()
            assert st["preemptions"] >= 1 and st["accepted_slo_misses"] == 0
            for i in range(3):
                r = srv.done[i]
                assert r.exit_layer == cfg.n_layers
                assert r.energy_j is not None and r.energy_j > 0 and r.latency_s <= arb.now_s
            return {"done": _done(srv), "telemetry": st, "now_s": arb.now_s}

        both(run)

    def test_preempt_flag_off_is_inert_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            for i in range(3):
                srv.submit(ns.Request(uid=i, tokens=tok[i][:12]))
            srv.step()
            srv.submit(ns.Request(uid=99, tokens=tok[4][:12], deadline_s=float(cfg.n_layers + 2)))
            st = srv.run()
            assert st["preemptions"] == 0 and st["restored_steps_saved"] == 0
            return {"done": _done(srv), "telemetry": st}

        both(run)


class TestTorchOversubscriptionStorm:
    def test_zero_accepted_slo_misses_under_storm_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            tok = _tokens(cfg, n=16)
            results = {}
            for admission in (True, False):
                ctrl = _controller(ns, cfg, 1.5)
                srv = _server(ns, model, params, batch_lanes=2, buckets=(16,),
                              arbiter=ns.dvfs.BatchedDVFSArbiter(ctrl), preempt=admission)
                ac = ns.AdmissionController(srv, max_best_effort_queue=4)
                submit = ac.submit if admission else srv.submit
                deadline = cfg.n_layers * ctrl.cycles_for_seq_len(16) / ctrl.max_op.freq_hz * 4.0
                for i in range(4):
                    submit(ns.Request(uid=i, tokens=tok[i][:12]))
                for j in range(10):
                    submit(ns.Request(uid=100 + j, tokens=tok[(j + 4) % 16][:12], deadline_s=deadline))
                results[admission] = {"telemetry": srv.run(), "done": _done(srv)}
            with_ac, without = results[True]["telemetry"], results[False]["telemetry"]
            assert with_ac["rejected"] > 0 and with_ac["accepted_slo_misses"] == 0
            assert without["accepted_slo_misses"] > 0 and with_ac["sentences"] >= 4
            return results

        both(run)


class TestTorchTelemetryGuards:
    def test_zero_retirees_all_keys_present_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,),
                          arbiter=ns.dvfs.BatchedDVFSArbiter(_controller(ns, cfg, 1.5)))
            st = srv.telemetry()
            for key in ("queue_delay_steps_p50", "queue_delay_steps_p95", "queue_delay_steps_p99",
                        "queue_delay_steps_max", "deadline_misses", "accepted_slo_misses",
                        "energy_j", "modeled_latency_s", "rejected", "requoted", "shed",
                        "preemptions", "restored_steps_saved"):
                assert st[key] == 0, key
            return st

        both(run)

    def test_no_explicit_slo_retirees_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns, threshold=0.5)
            tok = _tokens(cfg)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,),
                          arbiter=ns.dvfs.BatchedDVFSArbiter(_controller(ns, cfg, 1.5)))
            for i in range(3):
                srv.submit(ns.Request(uid=i, tokens=tok[i][:12]))
            st = srv.run()
            assert st["accepted_slo_misses"] == 0 and st["deadline_misses"] >= 0
            return {"done": _done(srv), "telemetry": st}

        both(run)


class TestTorchModeledClockOnly:
    def test_submit_never_stamps_wall_clock_matches_jax(self):
        def run(ns):
            model, params, cfg = _albert(ns)
            srv = _server(ns, model, params, batch_lanes=2, buckets=(16,))
            req = ns.Request(uid=0, tokens=_tokens(cfg)[0][:12])
            srv.submit(req)
            assert req.submit_time == 0.0
            assert req.arrival_s == srv.sched.now_s and req.arrival_step == 0
            return _req(req)

        both(run)


# ---------------------------------------------------------------------------
# the shared-clock arbiter's serving invariants (test_arbiter_properties.py),
# driven through both packages' BatchedDVFSArbiter
# ---------------------------------------------------------------------------

N_LAYERS = 12
HEADROOM = 1.25


def _arb_controller(ns, target_mult=1.5):
    stats = ns.stats(seq_len=32)
    stats.n_layers = N_LAYERS
    return ns.dvfs.LatencyAwareDVFSController(
        stats, ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * target_mult)


def _cold_layers(lane):
    kind, work = lane
    return float(work) if kind == "cls" else len(work) * float(N_LAYERS)


def _drive(arb, mix, deadline_of):
    """Admit and run a lane mix to completion on one shared clock, each
    round the classifier lanes (one layer each) then the decoder-shaped
    lanes (one token of its exit depth each), as test_arbiter_properties.py
    drives it.  Returns the retire reports."""
    for i, (kind, work) in enumerate(mix):
        arb.admit(i, deadline_s=deadline_of(i))
        if kind == "dec":
            arb.set_remaining_layers(i, len(work) * N_LAYERS)
    done, progress = {}, [0] * len(mix)
    while len(done) < len(mix):
        for kind_sel in ("cls", "dec"):
            active = [i for i in range(len(mix)) if i not in done and mix[i][0] == kind_sel]
            if not active:
                continue
            layers = {i: 1 if kind_sel == "cls" else int(mix[i][1][progress[i]]) for i in active}
            arb.step(active, layers=layers)
            for i in active:
                kind, work = mix[i]
                progress[i] += 1
                if kind == "cls":
                    if progress[i] == work:
                        done[i] = arb.retire(i, work)
                else:
                    arb.set_remaining_layers(i, (len(work) - progress[i]) * N_LAYERS)
                    if progress[i] == len(work):
                        done[i] = arb.retire(i, int(sum(work)))
    return done


def _reports(done):
    return {i: {"latency_s": r.latency_s, "energy_j": r.energy_j, "deadline_met": r.deadline_met}
            for i, r in sorted(done.items())}


def _admission_deadline(arb, ctrl, mix, i, mult=1.0):
    """Own cold service quote plus cross-traffic's full-depth work at the
    table's slowest point, times the admission headroom."""
    service = arb.min_latency_quote(_cold_layers(mix[i]))
    wait = sum(_cold_layers(mix[j]) for j in range(len(mix)) if j != i) \
        * ctrl.cycles_per_layer / ctrl.table[0].freq_hz
    return (wait + service) * HEADROOM * mult


def _quote_floor(ns, mix):
    """Zero-slack drains per kind group: realized latency never above the
    cold quote."""
    out = []
    for kind_sel in ("cls", "dec"):
        grp = [lane for lane in mix if lane[0] == kind_sel]
        if not grp:
            continue
        arb = ns.dvfs.BatchedDVFSArbiter(_arb_controller(ns))
        quotes = {i: arb.min_latency_quote(_cold_layers(lane)) for i, lane in enumerate(grp)}
        done = _drive(arb, grp, deadline_of=lambda i: 1e-12)
        for i, rep in done.items():
            assert rep.latency_s <= quotes[i] * (1 + 1e-9), (ns.name, grp, i)
        out.append({"quotes": quotes, "reports": _reports(done)})
    return out


def _slo_met(ns, mix, mult):
    ctrl = _arb_controller(ns)
    arb = ns.dvfs.BatchedDVFSArbiter(ctrl)
    dls = {i: _admission_deadline(arb, ctrl, mix, i, mult) for i in range(len(mix))}
    done = _drive(arb, mix, deadline_of=lambda i: dls[i])
    assert all(r.deadline_met for r in done.values()), (ns.name, mix, mult)
    return {"deadlines": dls, "reports": _reports(done)}


def _lane_energies(ns, lane, lo, hi):
    energies = []
    for mult in (lo, hi):
        arb = ns.dvfs.BatchedDVFSArbiter(_arb_controller(ns))
        done = _drive(arb, [lane], deadline_of=lambda i: (
            arb.min_latency_quote(_cold_layers(lane)) * HEADROOM * mult))
        energies.append(done[0].energy_j)
    assert energies[1] <= energies[0] * (1 + 1e-9), (ns.name, lane, lo, hi)
    return energies


def _seeded_mixes(n=40, seed=9):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mix = []
        for _ in range(int(rng.integers(1, 5))):
            if rng.random() < 0.5:
                mix.append(("cls", int(rng.integers(1, N_LAYERS + 1))))
            else:
                mix.append(("dec", [int(rng.integers(1, N_LAYERS + 1))
                                    for _ in range(int(rng.integers(1, 7)))]))
        out.append(mix)
    return out


_LANE = st.one_of(
    st.tuples(st.just("cls"), st.integers(min_value=1, max_value=N_LAYERS)),
    st.tuples(st.just("dec"), st.lists(st.integers(min_value=1, max_value=N_LAYERS),
                                       min_size=1, max_size=6)),
)
_MIX = st.lists(_LANE, min_size=1, max_size=4)


@pytest.mark.hypothesis
class TestTorchArbiterProperties:
    @given(mix=_MIX)
    @settings(max_examples=40, deadline=None)
    def test_cold_quote_floor_matches_jax(self, mix):
        assert_same(_quote_floor(JAX, mix), _quote_floor(TORCH, mix))

    @given(mix=_MIX, mult=st.floats(min_value=1.0, max_value=8.0))
    @settings(max_examples=40, deadline=None)
    def test_admission_priced_deadlines_met_matches_jax(self, mix, mult):
        assert_same(_slo_met(JAX, mix, mult), _slo_met(TORCH, mix, mult))

    @given(lane=_LANE, m_lo=st.floats(min_value=1.0, max_value=4.0),
           m_hi=st.floats(min_value=1.0, max_value=4.0))
    @settings(max_examples=40, deadline=None)
    def test_lane_energy_monotone_in_deadline_matches_jax(self, lane, m_lo, m_hi):
        lo, hi = sorted((m_lo, m_hi))
        assert_same(_lane_energies(JAX, lane, lo, hi), _lane_energies(TORCH, lane, lo, hi))


class TestTorchArbiterInvariants:
    """The same invariants without hypothesis: the two adversarial mixes
    that refute max-op cross-traffic pricing, and seeded sweeps."""

    HARD_MIXES = [[("cls", 12), ("dec", [12, 12])], [("dec", [3, 5, 11, 12]), ("cls", 11)]]

    def test_per_step_op_energy_monotone_matches_jax(self):
        def run(ns):
            ctrl = _arb_controller(ns)
            work_cycles = 5 * ctrl.cycles_per_layer
            prev, out = float("inf"), []
            for t_rem in np.linspace(1e-6, 50 * ctrl.layer_time_s(ctrl.max_op), 200):
                e = ctrl.layer_energy(ctrl.op_for_freq(work_cycles / t_rem))
                assert e <= prev * (1 + 1e-12)
                prev = e
                out.append(e)
            return out

        both(run)

    def test_hard_mixes_meet_stretch_priced_deadlines_matches_jax(self):
        both(lambda ns: [_slo_met(ns, mix, mult) for mix in self.HARD_MIXES
                         for mult in (1.0, 1.07, 2.0)])

    def test_seeded_sweep_quote_floor_and_slo_matches_jax(self):
        def run(ns):
            rng = np.random.default_rng(10)
            out = []
            for mix in _seeded_mixes():
                mult = 1.0 if rng.random() < 0.3 else float(1.0 + 7.0 * rng.random())
                out.append({"floor": _quote_floor(ns, mix), "slo": _slo_met(ns, mix, mult)})
            return out

        both(run)

    def test_seeded_sweep_lane_energy_monotone_matches_jax(self):
        def run(ns):
            rng = np.random.default_rng(11)
            out = []
            for mix in _seeded_mixes(n=20, seed=12):
                lo, hi = sorted((float(1 + 3 * rng.random()), float(1 + 3 * rng.random())))
                out.append(_lane_energies(ns, mix[0], lo, hi))
            return out

        both(run)
