"""Multi-task residency, port against the JAX package: the cases of
test_residency.py (deployment pricing, the SRAM working set over eNVM,
fault-injected readback, serving integration), ``span_flop_factor``,
``calibrate_predictor``, and the routers: ``MultiTaskRouter`` and
``ResidencyRouter`` drains over three tasks with their own weights.

Each case runs the same inputs through ``repro`` and ``repro_torch`` (smoke
``albert_edgebert``, float32; JAX-initialised params carried over by
``bridge.params_from_numpy``; the port's servers on the CPU, where its
kernel route runs the plain versions) and makes the reference test's
assertions on both.  Numpy-only results (pricing, footprints, swap
telemetry, readback arrays, spans) are equal; modeled floats agree within
rel 1e-9; per-request task and exit layer are equal and logits agree
within 2e-4, the bound test_torch_serving.py holds the serving drain to.
"""
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core import adaptive_span as j_span
from repro.data.synthetic import SyntheticCLS
from repro.hwmodel import edgebert_accel as j_hw
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving import engine as j_engine
from repro.serving import residency as j_res
from repro.serving.admission import AdmissionController as JAdmission
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core import adaptive_span as t_span
from repro_torch.hwmodel import edgebert_accel as t_hw
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving import engine as t_engine
from repro_torch.serving import residency as t_res
from repro_torch.serving.admission import AdmissionController as TAdmission

JAX = SimpleNamespace(name="jax", smoke=j_smoke, build=j_build, hw=j_hw, dvfs=jdvfs, engine=j_engine,
                      res=j_res, AdmissionController=JAdmission, server_kw={})
TORCH = SimpleNamespace(name="torch", smoke=t_smoke, build=t_build, hw=t_hw, dvfs=tdvfs,
                        engine=t_engine, res=t_res, AdmissionController=TAdmission,
                        server_kw={"device": "cpu"})
N_LAYERS = 12
TASKS = ("mnli", "qqp", "sst2")
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
    """Integers, flags, strings and None equal; floats within rel 1e-9;
    arrays equal."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


def both(scenario):
    out_j, out_t = scenario(JAX), scenario(TORCH)
    assert_same(out_j, out_t)
    return out_j, out_t


def _stats(ns, seq_len=64):
    s = ns.hw.albert_layer_stats(seq_len=seq_len)
    s.n_layers = N_LAYERS
    return s


def _controller(ns, target_mult=2.0):
    return ns.dvfs.LatencyAwareDVFSController(
        _stats(ns), ns.dvfs.no_early_exit_baseline(_stats(ns))["latency_s"] * target_mult)


def _dep(ns, task="mnli", occupancy=0.4, spans=(0,) * 6 + (64,) * 6):
    return ns.res.TaskDeployment(task, n_params=11e6, pruning_occupancy=occupancy, spans=spans,
                                 n_heads=12, span_seq_len=128)


def test_span_flop_factor_matches_jax():
    """Exact over a grid of spans, head counts and sequence lengths."""
    rng = np.random.default_rng(0)
    for n_heads in (1, 4, 12):
        for seq_len in (0, 1, 16, 64, 128, 512):
            for _ in range(8):
                spans = rng.integers(0, 600, n_heads)
                got = t_span.span_flop_factor(spans, n_heads, seq_len)
                assert got == j_span.span_flop_factor(spans, n_heads, seq_len), (spans, seq_len)
    assert t_span.span_flop_factor((0,) * 6 + (64,) * 6, 12, 128) == 0.25


class TestTorchDeploymentPricing:
    def test_compressed_deployment_lowers_cycles_and_power_matches_jax(self):
        def run(ns):
            ctrl, dep = _controller(ns), _dep(ns)
            dc = ns.res.deployment_controller(ctrl, dep)
            cycles = {S: (dc.cycles_for_seq_len(S), ctrl.cycles_for_seq_len(S)) for S in (16, 32, 64, 128)}
            assert all(c < base for c, base in cycles.values())
            scale = ns.res.deployment_energy_scale(ctrl, dep)
            assert scale < 1.0
            return {"cycles": cycles, "energy_scale": scale, "span_factor": dep.span_factor,
                    "heads_active_frac": dep.heads_active_frac}

        both(run)

    def test_dense_deployment_prices_identically_matches_jax(self):
        def run(ns):
            ctrl = _controller(ns)
            dense = ns.res.TaskDeployment("t", n_params=11e6)
            dc = ns.res.deployment_controller(ctrl, dense)
            assert dc.cycles_for_seq_len(64) == ctrl.cycles_for_seq_len(64)
            assert ns.res.deployment_energy_scale(ctrl, dense) == pytest.approx(1.0)
            return dc.cycles_for_seq_len(64)

        both(run)

    def test_cycles_energy_monotone_in_occupancy_matches_jax(self):
        def run(ns):
            out = []
            for S in (32, 64, 128):
                prev_c = prev_e = None
                for occ in (1.0, 0.8, 0.6, 0.4, 0.2):
                    st = ns.hw.scale_stats_to_seq_len(
                        ns.res.deployment_stats(_stats(ns), _dep(ns, occupancy=occ, spans=None)), S)
                    c, e = ns.hw.layer_cycles(st, use_span=True), ns.hw.layer_energy_j(st, vdd=0.80)
                    if prev_c is not None:
                        assert c <= prev_c + 1e-9 and e < prev_e
                    prev_c, prev_e = c, e
                    out.append((c, e))
            return out

        both(run)

    def test_cycles_energy_monotone_in_span_budget_matches_jax(self):
        budgets = [(64,) * 12, (32,) * 12, (0,) * 4 + (32,) * 8, (0,) * 8 + (16,) * 4]

        def run(ns):
            out = []
            for S in (32, 64):
                prev_c = prev_e = None
                for spans in budgets:
                    st = ns.hw.scale_stats_to_seq_len(
                        ns.res.deployment_stats(_stats(ns), _dep(ns, occupancy=1.0, spans=spans)), S)
                    c, e = ns.hw.layer_cycles(st, use_span=True), ns.hw.layer_energy_j(st, vdd=0.80)
                    if prev_c is not None:
                        assert c <= prev_c + 1e-9 and e <= prev_e + 1e-15
                    prev_c, prev_e = c, e
                    out.append((c, e))
            return out

        both(run)

    def test_analytic_storage_matches_bitmask_accounting_matches_jax(self):
        rng = np.random.default_rng(0)
        w = rng.standard_normal((256, 128)).astype(np.float32)
        w[rng.random(w.shape) < 0.6] = 0.0
        occ = float((w != 0).mean())

        def run(ns):
            dep = ns.res.TaskDeployment("t", n_params=w.size, pruning_occupancy=occ)
            measured = ns.res.measured_footprint({"w": w}, dep.fmt)
            analytic = dep.storage()
            assert measured["mask_bytes"] == analytic["mask_bytes"]
            assert measured["value_bytes"] == pytest.approx(analytic["value_bytes"], rel=1e-6)
            return {"measured": measured, "analytic": analytic}

        out_j, _ = both(run)
        # the port reads the weights of a parameter tree: tensors, on the
        # host here, float32 or bfloat16 (every zero survives the widening)
        fmt = t_res.TaskDeployment("t", n_params=w.size).fmt
        tree = {"layer": {"w": torch.from_numpy(w)}}
        assert t_res.measured_footprint(tree, fmt) == out_j["measured"]
        bf = t_res.measured_footprint({"w": torch.from_numpy(w).to(torch.bfloat16)}, fmt)
        assert bf["mask_bytes"] == out_j["measured"]["mask_bytes"]


class TestTorchResidencyManager:
    @staticmethod
    def _three_tasks(ns):
        deps = [_dep(ns, t, occupancy=0.4, spans=None) for t in ("a", "b", "c")]
        return ns.res.TaskResidencyManager(deps, sram_bytes=2 * deps[0].storage()["total_bytes"])

    def test_lru_eviction_and_swap_telemetry_matches_jax(self):
        def run(ns):
            m = self._three_tasks(ns)
            assert m.pending_swap_stall_s("a") > 0.0
            stalls, sets = [m.acquire("a")], []
            assert stalls[0] == pytest.approx(m.swap_cost("a")["latency_s"])
            stalls.append(m.acquire("a"))
            assert stalls[1] == 0.0 and m.pending_swap_stall_s("a") == 0.0
            for t, want in (("b", ("a", "b")), ("c", ("b", "c")), ("a", ("c", "a"))):
                stalls.append(m.acquire(t))
                assert m.resident_set == want
                sets.append(m.resident_set)
            t = m.telemetry()
            assert t["task_swaps"] == 4 and t["evictions"] == 2 and t["residency_hits"] == 1
            assert t["swap_stall_s"] == pytest.approx(4 * stalls[0])
            assert t["swap_energy_j"] == pytest.approx(4 * m.swap_cost("a")["energy_j"])
            assert t["resident_bytes"] <= t["sram_bytes"]
            return {"stalls": stalls, "sets": sets, "telemetry": t}

        both(run)

    def test_sparser_deployment_swaps_cheaper_matches_jax(self):
        def run(ns):
            lo = _dep(ns, "lo", occupancy=0.2, spans=None).swap_cost()
            hi = _dep(ns, "hi", occupancy=0.8, spans=None).swap_cost()
            assert lo["bytes"] < hi["bytes"] and lo["latency_s"] < hi["latency_s"]
            assert lo["energy_j"] < hi["energy_j"]
            s = _dep(ns, "lo", occupancy=0.2, spans=None).storage()
            assert lo == ns.hw.task_swap_cost(s["value_bytes"], s["mask_bytes"])
            return {"lo": lo, "hi": hi}

        both(run)

    def test_unmanaged_task_is_free_matches_jax(self):
        def run(ns):
            m = self._three_tasks(ns)
            out = [m.acquire(None), m.acquire("unknown"), m.pending_swap_stall_s("unknown")]
            assert out == [0.0, 0.0, 0.0] and m.task_swaps == 0
            return m.telemetry()

        both(run)


class TestTorchEnvmReadback:
    @staticmethod
    def _manager(ns):
        return ns.res.TaskResidencyManager([_dep(ns, "t", occupancy=0.5, spans=None)], sram_bytes=1e9)

    def test_paper_cell_config_roundtrips_clean_matches_jax(self):
        rng = np.random.default_rng(1)
        w = rng.standard_normal((96, 64)).astype(np.float32)
        w[rng.random(w.shape) < 0.5] = 0.0

        def run(ns, weight=w):
            m = self._manager(ns)
            out, stats = m.load_from_envm("t", {"w": weight}, data_cell="MLC2", mask_cell="SLC", seed=0)
            assert stats["n_mask_bit_flips"] == 0 and stats["n_code_faults"] == 0
            assert "t" not in m.degraded_tasks
            assert np.all(out["w"][w == 0] == 0)
            nz = w != 0
            assert np.median(np.abs(out["w"][nz] - w[nz]) / np.abs(w[nz])) < 0.05
            return {"out": out, "stats": {k: stats[k] for k in ("n_mask_bit_flips", "n_code_faults")}}

        out_j, _ = both(run)
        # a tensor weight is read on the host
        assert_same(out_j, run(TORCH, torch.from_numpy(w)))

    def test_mlc3_degrades_detectably_matches_jax(self):
        w = np.random.default_rng(2).standard_normal((128, 128)).astype(np.float32)

        def run(ns):
            m = self._manager(ns)
            out, stats = m.load_from_envm("t", {"w": w}, data_cell="MLC3", seed=0)
            assert stats["n_code_faults"] > 0
            assert "t" in m.degraded_tasks and "t" in m.telemetry()["degraded_tasks"]
            return {"out": out, "stats": {k: stats[k] for k in ("n_mask_bit_flips", "n_code_faults")}}

        both(run)


# ---------------------------------------------------------------------------
# serving integration and the routers
# ---------------------------------------------------------------------------


def _albert(ns, threshold=0.6):
    cfg = dataclasses.replace(ns.smoke("albert_edgebert"), dtype="float32", remat_policy="none")
    cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                           entropy_threshold=threshold))
    return ns.build(cfg), cfg


def _jax_params(seed):
    if seed not in _JPARAMS:
        cfg = dataclasses.replace(j_smoke("albert_edgebert"), dtype="float32", remat_policy="none")
        _JPARAMS[seed] = j_build(cfg).init_params(jax.random.PRNGKey(seed))
    return _JPARAMS[seed]


def _params(ns, seed=0):
    p = _jax_params(seed)
    return p if ns is JAX else params_from_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _smoke_controller(ns, cfg, target_mult=4.0):
    s = ns.hw.albert_layer_stats(seq_len=32)
    s.n_layers = cfg.n_layers
    return ns.dvfs.LatencyAwareDVFSController(s, ns.dvfs.no_early_exit_baseline(s)["latency_s"] * target_mult)


def _req_obs(r):
    return {"uid": r.uid, "exit_layer": r.exit_layer, "bucket": r.bucket, "arrival_s": r.arrival_s,
            "admit_s": r.admit_s, "retire_s": r.retire_s, "energy_j": r.energy_j,
            "latency_s": r.latency_s, "op_freq_hz": r.op_freq_hz}


def _router_obs(router):
    """Per task: each request's schedule, exit and modeled energy, plus its
    logits and entropy trace (compared within LOGIT_ATOL apart)."""
    out, vals = {}, {}
    for name, srv in router.tasks.items():
        out[name] = {uid: _req_obs(r) for uid, r in sorted(srv.done.items())}
        vals[name] = {uid: (np.asarray(r.result, np.float64), np.asarray(r.entropy_trace))
                      for uid, r in srv.done.items()}
    return out, vals


def _assert_router_values(vj, vt):
    assert vj.keys() == vt.keys()
    for name in vj:
        assert vj[name].keys() == vt[name].keys(), name
        for uid, (lg, ent) in vj[name].items():
            np.testing.assert_allclose(vt[name][uid][0], lg, atol=LOGIT_ATOL, rtol=0, err_msg=f"{name} {uid}")
            np.testing.assert_allclose(vt[name][uid][1], ent, atol=LOGIT_ATOL, rtol=0, err_msg=f"{name} {uid}")


class TestTorchServingIntegration:
    def test_resident_task_quotes_strictly_cheaper_matches_jax(self):
        def run(ns):
            model, cfg = _albert(ns)
            dep = _dep(ns, "mnli", occupancy=0.4, spans=None)
            res = ns.res.TaskResidencyManager([dep], sram_bytes=1e9)
            server = ns.engine.ClassifierServer(
                model, _params(ns), batch_lanes=2, buckets=(32,),
                arbiter=ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg)),
                task="mnli", residency=res, deployment=dep, **ns.server_kw)
            adm = ns.AdmissionController(server, headroom=1.25)
            req = ns.engine.Request(uid=0, tokens=np.arange(8), deadline_s=10.0)
            q_miss = adm.quote(req)
            res.acquire("mnli")
            q_hit = adm.quote(req)
            assert q_hit.min_deadline_s < q_miss.min_deadline_s
            assert q_miss.min_deadline_s - q_hit.min_deadline_s == pytest.approx(
                dep.swap_cost()["latency_s"] * adm.headroom)
            return {"miss": dict(vars(q_miss)), "hit": dict(vars(q_hit))}

        both(run)

    def test_compressed_deployment_lowers_quoted_service_matches_jax(self):
        def run(ns):
            model, cfg = _albert(ns)
            params = _params(ns)

            def mk(d):
                return ns.engine.ClassifierServer(
                    model, params, batch_lanes=2, buckets=(32,),
                    arbiter=ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg)),
                    task="mnli", deployment=d, **ns.server_kw)

            dense, compressed = mk(None), mk(_dep(ns, "mnli"))
            assert compressed._cycles_for(32) < dense._cycles_for(32)
            req = ns.engine.Request(uid=0, tokens=np.arange(8), deadline_s=10.0)
            q_dense = ns.AdmissionController(dense).quote(req)
            q_comp = ns.AdmissionController(compressed).quote(req)
            assert q_comp.service_s < q_dense.service_s and q_comp.min_deadline_s < q_dense.min_deadline_s
            return {"dense": dict(vars(q_dense)), "compressed": dict(vars(q_comp)),
                    "energy_scale": compressed._energy_scale}

        both(run)

    def test_swap_stall_burns_shared_clock_matches_jax(self):
        def run(ns):
            model, cfg = _albert(ns)
            dep = _dep(ns, "mnli", occupancy=0.4, spans=None)
            res = ns.res.TaskResidencyManager([dep], sram_bytes=1e9)
            arb = ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg))
            server = ns.engine.ClassifierServer(model, _params(ns), batch_lanes=2, buckets=(32,),
                                                arbiter=arb, task="mnli", residency=res,
                                                deployment=dep, **ns.server_kw)
            server.submit(ns.engine.Request(uid=0, tokens=np.arange(8)))
            server.step()
            stall = dep.swap_cost()["latency_s"]
            assert res.task_swaps == 1 and arb.now_s >= stall and server.sched.now_s >= stall
            server.run()
            return {"now_s": arb.now_s, "sched_now_s": server.sched.now_s,
                    "done": {u: _req_obs(r) for u, r in server.done.items()},
                    "telemetry": server.telemetry()}

        both(run)

    def test_affinity_batches_tasks_and_bounds_swaps_matches_jax(self):
        """Working set of two for three tasks: affinity stepping swaps each
        task in once, residency-blind EDF thrashes; both packages take the
        same steps.  Every task serves the same params, as in the
        reference test."""
        n_req = 4

        def run(ns, policy):
            model, cfg = _albert(ns)
            params = _params(ns)
            deps = {t: _dep(ns, t, occupancy=0.4, spans=None) for t in TASKS}
            res = ns.res.TaskResidencyManager(deps, sram_bytes=2 * deps["mnli"].storage()["total_bytes"])
            router = ns.res.ResidencyRouter(
                model, params["embed"], {t: params for t in deps}, residency=res, deployments=deps,
                task_policy=policy, arbiter=ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg)),
                buckets=(32,), batch_lanes=2, **ns.server_kw)
            tok = SyntheticCLS(cfg.vocab_size, 32, 16, num_classes=3, seed=0).batch(0)["tokens"]
            for i in range(3 * n_req):
                router.submit(TASKS[i % 3], ns.engine.Request(uid=i, tokens=tok[i][:8],
                                                              deadline_s=5.0 + i * 1e-4))
            out = router.run_all()
            assert set(out) == set(TASKS)
            for tel in out.values():
                assert tel["accepted_slo_misses"] == 0 and tel["step_traces"] <= 1
            assert all(len(router.tasks[t].done) == n_req for t in out)
            obs, vals = _router_obs(router)
            return {"per_task": out, "requests": obs, "router": router.telemetry(),
                    "task_switches": router.task_switches, "switches": router.switches}, vals

        results = {}
        for pol in ("affinity", "blind"):
            (oj, vj), (ot, vt) = [run(ns, getattr(ns.res, "TaskAffinityPolicy" if pol == "affinity"
                                                  else "BlindEDFTaskPolicy")()) for ns in (JAX, TORCH)]
            assert_same(oj, ot)
            _assert_router_values(vj, vt)
            results[pol] = oj
        aff, blind = results["affinity"]["router"], results["blind"]["router"]
        assert aff["task_swaps"] == 3
        assert blind["task_swaps"] > aff["task_swaps"] and blind["swap_stall_s"] > aff["swap_stall_s"]
        assert results["blind"]["task_switches"] > results["affinity"]["task_switches"]


def _distinct_task_params(ns, tasks):
    """Task i's encoder and head from seed 10 + i; the embedding of task 0."""
    by_task = {t: _params(ns, 10 + i) for i, t in enumerate(tasks)}
    return by_task[tasks[0]]["embed"], by_task


def _traffic(cfg, n=24):
    tok = SyntheticCLS(cfg.vocab_size, 32, n, num_classes=3, seed=4).batch(0)["tokens"]
    lens = np.random.default_rng(4).integers(6, 33, n)
    return [(TASKS[i % 3], tok[i][: int(lens[i])]) for i in range(n)]


class TestTorchRouters:
    def test_multitask_router_drain_matches_jax(self):
        """Three tasks with their own encoder and head weights behind one
        embedding table and one arbiter, drained task by task: per-request
        exits, modeled schedule and energy equal, logits within 2e-4.  In
        the port every task server holds the one table the router moved to
        the device."""
        def run(ns):
            model, cfg = _albert(ns)
            embed, by_task = _distinct_task_params(ns, TASKS)
            router = ns.engine.MultiTaskRouter(
                model, embed, by_task, arbiter=ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg)),
                buckets=(16, 32), batch_lanes=2, **ns.server_kw)
            for i, (t, tokens) in enumerate(_traffic(cfg)):
                router.submit(t, ns.engine.Request(uid=i, tokens=tokens))
            out = router.run_all()
            assert router.switches == 3 and router.embed_reloads == 1
            obs, vals = _router_obs(router)
            return {"per_task": out, "requests": obs}, vals, router

        (oj, vj, _), (ot, vt, rt) = run(JAX), run(TORCH)
        assert_same(oj, ot)
        _assert_router_values(vj, vt)
        ptrs = {t: srv.params["embed"]["tok"].data_ptr() for t, srv in rt.tasks.items()}
        assert len(set(ptrs.values())) == 1 and rt.shared_embed["tok"].data_ptr() in ptrs.values()
        heads = {t: srv.params["offramp"]["offramp_cls_w"].data_ptr() for t, srv in rt.tasks.items()}
        assert len(set(heads.values())) == len(TASKS)       # each task its own head
        # distinct weights: the same tokens give different logits per task
        lg = {t: next(iter(v.values()))[0] for t, v in vt.items()}
        assert not np.allclose(lg["mnli"], lg["qqp"])

    def test_residency_router_drain_matches_jax(self):
        """The same traffic under affinity stepping with explicit SLOs, a
        working set of two tasks and compressed deployments: swap stalls on
        the shared clock, per-request task and exit, energy equal."""
        def run(ns):
            model, cfg = _albert(ns)
            embed, by_task = _distinct_task_params(ns, TASKS)
            deps = {t: _dep(ns, t) for t in TASKS}
            res = ns.res.TaskResidencyManager(deps, sram_bytes=2 * deps["mnli"].storage()["total_bytes"])
            router = ns.res.ResidencyRouter(
                model, embed, by_task, residency=res, deployments=deps,
                arbiter=ns.dvfs.BatchedDVFSArbiter(_smoke_controller(ns, cfg)),
                buckets=(16, 32), batch_lanes=2, **ns.server_kw)
            for i, (t, tokens) in enumerate(_traffic(cfg)):
                router.submit(t, ns.engine.Request(uid=i, tokens=tokens,
                                                   deadline_s=None if i % 2 else 2.0 + i * 1e-3))
            out = router.run_all()
            tel = router.telemetry()
            assert tel["task_swaps"] >= 3 and tel["accepted_slo_misses"] == 0
            obs, vals = _router_obs(router)
            return {"per_task": out, "requests": obs, "router": tel,
                    "task_switches": router.task_switches}, vals

        (oj, vj), (ot, vt) = run(JAX), run(TORCH)
        assert_same(oj, ot)
        _assert_router_values(vj, vt)


def test_calibrate_predictor_matches_jax():
    """The Alg. 1 LUT from the dense forward of each package: the same bin
    exits, edges within 1e-6 (float32 entropies in another sum order)."""
    cfgs = [dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
            for get in (j_smoke, t_smoke)]
    cfgs = [c.with_edgebert(early_exit=dataclasses.replace(c.edgebert.early_exit,
                                                           entropy_threshold=1.05)) for c in cfgs]
    batches = [SyntheticCLS(cfgs[0].vocab_size, 32, 16, num_classes=3, seed=0).batch(100 + i)
               for i in range(2)]
    pj = jdvfs.calibrate_predictor(j_build(cfgs[0]), _params(JAX), batches, quantile=1.0)
    pt = tdvfs.calibrate_predictor(t_build(cfgs[1]), _params(TORCH), batches, quantile=1.0)
    np.testing.assert_array_equal(pt.bin_exit, pj.bin_exit)
    np.testing.assert_allclose(pt.bin_edges, pj.bin_edges, atol=1e-6, rtol=0)
    assert len(set(pj.bin_exit.tolist())) > 1           # the threshold spreads the exits


def test_block_index_refuses_inference_mode_weights():
    """Several task servers build block indices over weight tensors; an
    inference-mode tensor records no in-place change, so the card route
    refuses one (its packed tiles could go stale) at build and at every
    weight check.  The CPU route reads the weight itself and takes one."""
    from repro_torch.kernels import block_sparse as bs

    gen = torch.Generator().manual_seed(0)
    mask = np.random.default_rng(0).random((2, 2)) < 0.7
    mask[0, 0] = True
    w = torch.randn(64, 64, generator=gen)
    idx = bs.BlockIndex.build(mask, 32, 32, "cpu", w=w)
    idx.check_weight(w)
    bs.require_versioned(w)
    with torch.inference_mode():
        w_inf = torch.randn(64, 64, generator=gen)
    assert w_inf.is_inference()
    with pytest.raises(ValueError, match="inference-mode"):
        bs.require_versioned(w_inf)
    with pytest.raises(ValueError, match="inference-mode"):
        bs.BlockIndex.build(mask, 32, 32, "cuda", w=w_inf)      # refused before any copy
    with pytest.raises(ValueError, match="inference-mode"):
        idx.check_weight(w_inf)
    cpu_idx = bs.BlockIndex.build(mask, 32, 32, "cpu", w=w_inf)
    x = torch.randn(5, 64, generator=gen)
    with torch.inference_mode():
        got = bs.block_sparse_matmul(x, w_inf, cpu_idx)
    keep = torch.from_numpy(np.kron(mask, np.ones((32, 32)))).float()
    torch.testing.assert_close(got, x @ (w_inf * keep), atol=1e-5, rtol=0)
