"""Lane-sharded serving, port against the JAX package: the cases of
test_sharded_serving.py, each run through both packages where the JAX side
has numbers.

The port's replicas take a device list (``devices=``) where the JAX package
takes a mesh; on the CPU every replica is a CPU replica, the counterpart of
the JAX package's forced host devices.  The JAX package's sharded server
cannot serve as the baseline (its own tests fail 5 of these cases on this
tree: under this JAX it counts two step traces per (bucket, mesh), and its
4-replica classifier logits drift by up to 3.6e-7 from the unsharded
server's), so every drain is held against the JAX *unsharded* server:

* R = 1 (``devices=["cpu"]``, the sharded path with one replica): bit for
  bit against the port's unsharded server (results, exits, every telemetry
  counter); against the JAX unsharded server results within ATOL, exits
  and telemetry equal, one build per (bucket, 1).
* R = 4 x 2 lanes on four CPU replicas: against the JAX 8-lane unsharded
  server, exits equal and logits within R4_ATOL = 1e-6 (the JAX package's
  own 4-replica drift is 3.6e-7, float32 sums in another order; measured
  here 3.6e-7 too), and the decoder's generated tokens equal for the
  dense, MoE, ssm, hybrid, encdec and vlm families (dense also with
  per-token exit and spec window 4); one build per (bucket, 4).  The ssm
  and hybrid families are held against the JAX server with every request
  first in its lane (8 requests, 8 lanes: ROADMAP Queue 3 item 7).  The
  MoE prefill routes each lane with the whole fleet's 8 lanes, as the JAX
  package's prefill does.
* Host-side cases (placement, domain routing, per-replica quoting, the
  cross-replica lane clock, expanded arbiters): both packages' decisions
  equal, modeled floats within rel 1e-9.
* ``_resolve_devices``: the port's counterpart of ``_resolve_mesh``.

Smoke configs in float32; the JAX package initialises the params and the
weight bridge carries them across.  The classifier's threshold 0.5 lies
below every smoke entropy (untrained off-ramps give ~log 3), so every exit
is the full depth on both sides whatever the float32 noise.  One torch
intra-op thread, as the serving test files pin it.
"""
import copy
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.pruning import magnitude_mask as j_magnitude_mask
from repro.data.synthetic import SyntheticCLS, SyntheticLM
from repro.hwmodel.edgebert_accel import albert_layer_stats as j_stats
from repro.models.model import build_model as j_build
from repro.serving import admission as jadm
from repro.serving import dvfs as jdvfs
from repro.serving import engine as jengine
from repro.serving import scheduler as jsched
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.launch import serve_sharded
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import admission as tadm
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving import engine as tengine
from repro_torch.serving import scheduler as tsched
from tests.test_torch_decoder_families_server import _models as _families_models
from tests.test_torch_moe_server import _models as _moe_models
from tests.test_torch_ssm_server import _models as _plain_models

ATOL = 2e-4        # the port's unsharded serving against the JAX server (test_torch_serving.py)
R4_ATOL = 1e-6     # R = 4 x 2 against the JAX 8-lane server; the JAX package's own drift is 3.6e-7
DEC_ATOL = 1e-5    # decoder logits and entropies against the JAX server (test_torch_decoder_server.py)

JAX = SimpleNamespace(name="jax", adm=jadm, dvfs=jdvfs, engine=jengine, sched=jsched, stats=j_stats)
TORCH = SimpleNamespace(name="torch", adm=tadm, dvfs=tdvfs, engine=tengine, sched=tsched, stats=t_stats)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_float(a, b, path):
    assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)


_ALBERT = {}


def _albert(threshold=0.5, span=True, prune=False):
    """{"jax": (model, params), "torch": (model, params), "cfg"}: smoke
    albert_edgebert in float32 at ``threshold`` (JAX key 0), optionally span
    off and the MLP magnitude-pruned in 32 x 32 tiles."""
    key = (threshold, span, prune)
    if key not in _ALBERT:
        jcfg, tcfg = (c.with_edgebert(
            early_exit=dataclasses.replace(c.edgebert.early_exit, entropy_threshold=threshold),
            span=dataclasses.replace(c.edgebert.span, enabled=span))
            for c in (dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
                      for get in (j_smoke, t_smoke)))
        jm = j_build(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(0))
        if prune:
            mlp = dict(jp["layer"]["mlp"])
            for name in ("w_up", "w_down"):
                mlp[name] = mlp[name] * j_magnitude_mask(mlp[name], jcfg.edgebert.prune.encoder_sparsity,
                                                         block_size=32)
            jp = dict(jp, layer=dict(jp["layer"], mlp=mlp))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _ALBERT[key] = {"jax": (jm, jp), "torch": (t_build(tcfg), tp), "cfg": tcfg}
    return _ALBERT[key]


def _classify(pkg, c, lengths, *, seed=0, n_batch=None, **kw):
    """A ClassifierServer drain of the first SyntheticCLS sentences of a
    batch of ``n_batch`` (default: one per length; ``seed``) cut to
    ``lengths``; the JAX server unsharded, the port's on the CPU."""
    model, params = c[pkg]
    batch = SyntheticCLS(c["cfg"].vocab_size, 32, n_batch or len(lengths), num_classes=3, seed=seed).batch(0)
    if pkg == "jax":
        srv, R = jengine.ClassifierServer(model, params, **kw), jengine.Request
    else:
        srv, R = tengine.ClassifierServer(model, params, device="cpu", **kw), tengine.Request
    for i, n in enumerate(lengths):
        srv.submit(R(uid=i, tokens=batch["tokens"][i][:n]))
    return srv, srv.run()


def _decode(pkg, c, n=8, *, new=4, prompts=None, **kw):
    """A DecoderServer drain of ``prompts`` (default: ``n`` SyntheticLM
    prompts of 8 tokens, seed 0), ``new`` tokens each, bucket 16."""
    model, params = c[pkg]
    if prompts is None:
        toks = SyntheticLM(c["cfg"].vocab_size, 16, n, seed=0).batch(0)["tokens"]
        prompts = [np.asarray(t[:8], np.int32) for t in toks[:n]]
    if pkg == "jax":
        srv, R = jengine.DecoderServer(model, params, max_seq=48, eos_id=-1, buckets=(16,), **kw), jengine.Request
    else:
        srv, R = (tengine.DecoderServer(model, params, max_seq=48, eos_id=-1, buckets=(16,), device="cpu", **kw),
                  tengine.Request)
    for i, p in enumerate(prompts):
        srv.submit(R(uid=i, tokens=p, max_new_tokens=new))
    return srv, srv.run()


CLS_TELEMETRY = ("sentences", "layer_calls", "dense_steps", "avg_exit_layer", "step_traces", "embed_traces",
                 "insert_traces", "step_traces_per_bucket", "step_traces_per_bucket_replica")
DEC_TELEMETRY = ("completed", "tokens", "decode_steps", "decode_traces", "prefill_traces",
                 "step_traces_per_bucket", "step_traces_per_bucket_replica", "token_layer_calls",
                 "avg_token_exit_layer")


# ===========================================================================
# one replica: the sharded path against the unsharded servers
# ===========================================================================


class TestOneReplicaParity:
    LENGTHS = (10, 16, 24, 32, 12, 30)

    def _classifier_case(self, c, **kw):
        ref, t_ref = _classify("torch", c, self.LENGTHS, batch_lanes=2, buckets=(16, 32), **kw)
        shd, t_shd = _classify("torch", c, self.LENGTHS, batch_lanes=2, buckets=(16, 32), devices=["cpu"], **kw)
        assert shd.replicas == 1 and [d.type for d in shd.devices] == ["cpu"]
        for i in range(len(self.LENGTHS)):
            assert shd.done[i].exit_layer == ref.done[i].exit_layer, i
            assert np.array_equal(shd.done[i].result, ref.done[i].result), i
        for k in CLS_TELEMETRY:
            assert t_shd[k] == t_ref[k], k
        assert t_shd["replicas"] == 1 and t_shd["step_traces_per_bucket_replica"] == {"16x1": 1, "32x1": 1}
        return shd, t_shd

    def test_classifier_sharded_r1_bit_identical(self):
        c = _albert(0.5)
        shd, t_shd = self._classifier_case(c, use_kernels=False)
        jsrv, t_j = _classify("jax", c, self.LENGTHS, batch_lanes=2, buckets=(16, 32))
        for i in range(len(self.LENGTHS)):
            assert shd.done[i].exit_layer == jsrv.done[i].exit_layer == c["cfg"].n_layers, i
            np.testing.assert_allclose(shd.done[i].result, np.asarray(jsrv.done[i].result), atol=ATOL, rtol=0)
        for k in CLS_TELEMETRY:
            assert t_shd[k] == t_j[k], k

    @pytest.mark.parametrize("variant", ["shipped", "nospan_pruned"])
    def test_classifier_sharded_r1_kernels_eligible(self, variant):
        """The kernel route (on the CPU the kernels' plain versions, the
        block masks and their index per device) through the sharded path,
        bit for bit against the unsharded kernel route and within ATOL of
        the JAX server's Pallas route."""
        c = _albert(0.5, span=variant == "shipped", prune=variant == "nospan_pruned")
        shd, _ = self._classifier_case(c, use_kernels=True)
        if variant == "nospan_pruned":
            assert shd._block_masks[0]["w_up"] is not None
        jsrv, _ = _classify("jax", c, self.LENGTHS, batch_lanes=2, buckets=(16, 32), use_pallas=True)
        for i in range(len(self.LENGTHS)):
            assert shd.done[i].exit_layer == jsrv.done[i].exit_layer, i
            np.testing.assert_allclose(shd.done[i].result, np.asarray(jsrv.done[i].result), atol=ATOL, rtol=0)

    def _decoder_case(self, **kw):
        c = _plain_models("deepseek_7b")
        ref, t_ref = _decode("torch", c, 3, batch_lanes=2, **kw)
        shd, t_shd = _decode("torch", c, 3, batch_lanes=2, devices=["cpu"], **kw)
        jsrv, t_j = _decode("jax", c, 3, batch_lanes=2, **kw)
        assert shd.replicas == 1
        for i in range(3):
            assert shd.done[i].generated == ref.done[i].generated == jsrv.done[i].generated, i
            assert shd.done[i].token_exit_layers == ref.done[i].token_exit_layers == jsrv.done[i].token_exit_layers
        for k in DEC_TELEMETRY:
            assert t_shd[k] == t_ref[k] == t_j[k], k
        assert t_shd["step_traces_per_bucket_replica"] == {"16x1": 1}
        return shd, ref

    def test_decoder_sharded_r1_bit_identical(self):
        self._decoder_case()

    def test_decoder_ee_sharded_r1_bit_identical(self):
        """Per-token exit through the sharded path: tokens, exit depths and
        the final logits of every request equal to the unsharded server's."""
        shd, ref = self._decoder_case(exit_threshold=2.0)
        for i in range(3):
            assert np.array_equal(shd.done[i].result, ref.done[i].result), i


# ===========================================================================
# four CPU replicas against the JAX 8-lane unsharded server
# ===========================================================================


class TestFourReplicas:
    def test_classifier_r4_matches_unsharded_one_build(self):
        """16 requests through R = 4 x 2 lanes against the JAX 8-lane
        server: exits equal, logits within R4_ATOL; one build per (bucket,
        4); and against the port's 8-lane server exits equal."""
        c = _albert(0.5)
        lengths = (12,) * 16
        jsrv, _ = _classify("jax", c, lengths, batch_lanes=8, buckets=(16,))
        flat, _ = _classify("torch", c, lengths, batch_lanes=8, buckets=(16,))
        shd, t_shd = _classify("torch", c, lengths, batch_lanes=2, buckets=(16,), replicas=4)
        assert shd.lanes == 8 and shd.replicas == 4 and len(shd.devices) == 4
        for i in range(16):
            assert shd.done[i].exit_layer == jsrv.done[i].exit_layer == flat.done[i].exit_layer, i
            np.testing.assert_allclose(shd.done[i].result, np.asarray(jsrv.done[i].result), atol=R4_ATOL, rtol=0)
            np.testing.assert_allclose(shd.done[i].result, flat.done[i].result, atol=R4_ATOL, rtol=0)
        assert t_shd["step_traces_per_bucket_replica"] == {"16x4": 1}

    FAMILIES = {"dense": "deepseek_7b", "moe": "qwen2_moe_a2p7b", "ssm": "rwkv6_7b", "hybrid": "zamba2_1p2b",
                "encdec": "whisper_medium", "vlm": "llama3_2_vision_90b"}

    @staticmethod
    def _family(arch):
        if arch == "qwen2_moe_a2p7b":
            return _moe_models()
        if arch in ("whisper_medium", "llama3_2_vision_90b"):
            return _families_models(arch)
        return _plain_models(arch)

    @pytest.mark.parametrize("mode", ["dense", "moe", "ssm", "hybrid", "encdec", "vlm", "dense_exit", "dense_spec4",
                                      "moe_exit"])
    def test_decoder_r4_matches_unsharded_one_build(self, mode):
        """Requests through R = 4 x 2 lanes against the JAX 8-lane server:
        generated tokens equal, and with exit the exit depths equal and the
        final logits and entropy traces within DEC_ATOL; one build per
        (bucket, 4).  Eight requests, every one first in its lane, but for
        ``moe_exit``: the MoE server test's 12 requests of 3-9 tokens, with
        refills, whose prefill in lanes 4-7 loses expert slots to the dummy
        lanes of the JAX package's fleet-wide prefill (the port's slab of 2
        lanes routes with the fleet's 8 to match)."""
        family, _, variant = mode.partition("_")
        c = self._family(self.FAMILIES[family])
        jm, jp = c["jax"]
        kw, prompts = {}, None
        if family == "moe" and variant:
            prompts = [np.random.default_rng(2).integers(4, c["cfg"].vocab_size, size=L).astype(np.int32)
                       for L in (6, 5, 7, 4, 9, 3, 6, 8, 5, 7, 4, 6)]
            rng = np.random.default_rng(0)
            probe = [rng.integers(4, c["cfg"].vocab_size, size=L).astype(np.int32) for L in (6, 5, 7, 4, 6)]
            kw["exit_threshold"] = jengine.probe_exit_threshold(jm, jp, probe, max_new_tokens=4, quantile=0.8)
        elif variant:
            toks = SyntheticLM(c["cfg"].vocab_size, 16, 8, seed=0).batch(0)["tokens"]
            kw["exit_threshold"] = jengine.probe_exit_threshold(
                jm, jp, [np.asarray(t[:8], np.int32) for t in toks], max_new_tokens=4, quantile=0.5)
            if variant == "spec4":
                kw["spec_window"] = 4
        jsrv, t_j = _decode("jax", c, batch_lanes=8, prompts=prompts, **kw)
        shd, t_shd = _decode("torch", c, batch_lanes=2, replicas=4, prompts=prompts, **kw)
        n = len(jsrv.done)
        assert t_shd["completed"] == n and all(len(shd.done[i].generated) == 4 for i in range(n))
        for i in range(n):
            assert shd.done[i].generated == jsrv.done[i].generated, i
            assert shd.done[i].token_exit_layers == jsrv.done[i].token_exit_layers, i
            if variant:
                np.testing.assert_allclose(shd.done[i].result, np.asarray(jsrv.done[i].result), atol=DEC_ATOL,
                                           rtol=0)
                np.testing.assert_allclose(shd.done[i].entropy_trace, jsrv.done[i].entropy_trace,
                                           atol=DEC_ATOL, rtol=0)
        assert t_shd["step_traces_per_bucket_replica"] == {"16x4": 1}
        assert t_shd["prefill_traces"] == 1 and t_shd["decode_steps"] == t_j["decode_steps"]

    def test_checkpoint_on_replica_a_restores_on_replica_b(self):
        """uid 0 starts on replica 0's only lane; a contract pinned to
        replica 0 evicts it, and the same refill restores it into replica
        1's lane: its exit and logits bit for bit those of an uninterrupted
        single-lane run, and its exit that of the JAX package's."""
        c = _albert(1e-9)
        batch = SyntheticCLS(c["cfg"].vocab_size, 32, 8, num_classes=3, seed=0).batch(0)
        model, params = c["torch"]
        ref = tengine.ClassifierServer(model, params, batch_lanes=1, buckets=(16,), device="cpu")
        ref.submit(tengine.Request(uid=0, tokens=batch["tokens"][0][:12]))
        ref.run()
        jref, _ = _classify("jax", c, (12,), n_batch=8, batch_lanes=1, buckets=(16,))
        srv = tengine.ClassifierServer(model, params, batch_lanes=1, buckets=(16,), replicas=2, preempt=True,
                                       device="cpu")
        srv.submit(tengine.Request(uid=0, tokens=batch["tokens"][0][:12]))
        srv.step()
        srv.step()
        tight = tengine.Request(uid=99, tokens=batch["tokens"][1][:12], deadline_s=float(c["cfg"].n_layers * 6))
        tight.replica = 0
        srv.submit(tight)
        srv.step()
        assert srv.telemetry()["preemptions"] == 1
        run = srv.sched._open[16]
        assert run.lane_req[0].uid == 99 and run.lane_req[1].uid == 0
        assert srv.done.get(0) is None
        while srv.step() is not None:
            pass
        assert 0 in srv.done and 99 in srv.done
        assert srv.done[0].exit_layer == ref.done[0].exit_layer == jref.done[0].exit_layer
        assert np.array_equal(srv.done[0].result, ref.done[0].result)
        np.testing.assert_allclose(srv.done[0].result, np.asarray(jref.done[0].result), atol=ATOL, rtol=0)

    def test_decoder_checkpoint_moves_across_replicas(self):
        """uid 0 decodes on replica 0's only lane; a contract pinned to
        replica 0 evicts it, and the same refill restores its cache row,
        position and pending token into replica 1's lane: its tokens, exit
        depths and final logits bit for bit those of an uninterrupted
        single-lane run, its tokens those of the JAX server's."""
        c = _plain_models("deepseek_7b")
        model, params = c["torch"]
        toks = SyntheticLM(c["cfg"].vocab_size, 16, 2, seed=0).batch(0)["tokens"]
        prompt = np.asarray(toks[0][:8], np.int32)
        kw = dict(max_seq=48, eos_id=-1, buckets=(16,), exit_threshold=2.0, device="cpu")
        ref = tengine.DecoderServer(model, params, batch_lanes=1, **kw)
        ref.submit(tengine.Request(uid=0, tokens=prompt, max_new_tokens=6))
        ref.run()
        jsrv, _ = _decode("jax", c, 1, batch_lanes=1, new=6, exit_threshold=2.0)
        srv = tengine.DecoderServer(model, params, batch_lanes=1, replicas=2, preempt=True, **kw)
        srv.submit(tengine.Request(uid=0, tokens=prompt, max_new_tokens=6))
        srv.step()
        srv.step()
        tight = tengine.Request(uid=99, tokens=np.asarray(toks[1][:4], np.int32), max_new_tokens=2,
                                deadline_s=30.0)
        tight.replica = 0
        srv.submit(tight)
        srv.step()
        assert srv.telemetry()["preemptions"] == 1
        run = srv.sched._open[16]
        assert run.lane_req[0].uid == 99 and run.lane_req[1].uid == 0
        while srv.step() is not None:
            pass
        got = srv.done[0]
        assert got.generated == ref.done[0].generated == jsrv.done[0].generated
        assert got.token_exit_layers == ref.done[0].token_exit_layers
        assert np.array_equal(got.result, ref.done[0].result)


# ===========================================================================
# placement policies
# ===========================================================================


def _q(ns, replica, min_deadline, wait=0.0, feasible=True):
    return ns.adm.Quote(bucket=16, service_s=0.1, wait_s=wait, min_deadline_s=min_deadline,
                        feasible=feasible, replica=replica)


def _both(case):
    out = {ns.name: case(ns) for ns in (JAX, TORCH)}
    assert out["jax"] == out["torch"], out
    return out["torch"]


class TestPlacementPolicies:
    def test_least_loaded_picks_earliest_feasible_deadline(self):
        got = _both(lambda ns: ns.adm.LeastLoadedPlacement().choose(
            [_q(ns, 0, 3.0), _q(ns, 1, 1.5), _q(ns, 2, 2.0)]).replica)
        assert got == 1

    def test_deadline_packed_picks_busiest_feasible(self):
        got = _both(lambda ns: ns.adm.DeadlinePackedPlacement().choose(
            [_q(ns, 0, 3.0), _q(ns, 1, 1.5), _q(ns, 2, 2.0)]).replica)
        assert got == 0

    def test_wait_breaks_ties(self):
        got = _both(lambda ns: (
            ns.adm.LeastLoadedPlacement().choose([_q(ns, 0, 2.0, wait=0.5), _q(ns, 1, 2.0, wait=0.1)]).replica,
            ns.adm.DeadlinePackedPlacement().choose([_q(ns, 0, 2.0, wait=0.5), _q(ns, 1, 2.0, wait=0.1)]).replica))
        assert got == (1, 0)


# ===========================================================================
# replica-pinned refill on the bare scheduler
# ===========================================================================


class _RecordingEngine:
    """Bare-scheduler stub: retires every lane after one step and records
    ``(step_index, lane, uid)`` for each ``lane_load``."""

    def __init__(self, lanes_per_replica):
        self.lpr = lanes_per_replica
        self.loads = []
        self._steps = 0

    def bucket_key(self, req):
        return len(req.tokens)

    def lane_domain(self, lane):
        return lane // self.lpr

    def bucket_begin(self, bucket):
        pass

    def lane_load(self, bucket, lane, req):
        self.loads.append((self._steps, lane, req.uid))

    def lanes_step(self, bucket, active):
        self._steps += 1
        return None

    def lane_advance(self, bucket, lane, req, out, depth):
        return True

    def lane_finish(self, bucket, lane, req, depth):
        pass

    def bucket_end(self, bucket):
        pass


def _sched(ns, lanes_per_replica=1, replicas=2):
    eng = _RecordingEngine(lanes_per_replica)
    return ns.sched.LaneScheduler(lanes_per_replica * replicas, eng, buckets=(16,)), eng


TOKS = np.arange(1, 9, dtype=np.int32)


class TestDomainRouting:
    def test_pinned_request_only_fills_its_domain(self):
        def case(ns):
            sched, eng = _sched(ns)
            r0 = ns.engine.Request(uid=0, tokens=TOKS)
            r0.replica = 1
            sched.submit(r0)
            rep = sched.step()
            return rep.n_active, [(lane, uid) for _, lane, uid in eng.loads]

        assert _both(case) == (1, [(1, 0)])

    def test_unpinned_requests_fill_any_domain(self):
        def case(ns):
            sched, eng = _sched(ns)
            for i in range(2):
                sched.submit(ns.engine.Request(uid=i, tokens=TOKS))
            rep = sched.step()
            return rep.n_active, sorted(lane for _, lane, _ in eng.loads)

        assert _both(case) == (2, [0, 1])

    def test_incompatible_pin_does_not_block_compatible_younger(self):
        def case(ns):
            sched, eng = _sched(ns)
            for i, pin in enumerate((0, 0, 1)):
                r = ns.engine.Request(uid=i, tokens=TOKS)
                r.replica = pin
                sched.submit(r)
            rep = sched.step()
            first = sorted((lane, uid) for s, lane, uid in eng.loads if s == 0)
            sched.step()
            return rep.n_active, first, list(eng.loads)

        n, first, loads = _both(case)
        assert n == 2 and first == [(0, 0), (1, 2)] and (1, 0, 1) in loads


# ===========================================================================
# the cross-replica lane clock (per-replica DVFS domains)
# ===========================================================================


def _ctrl(ns):
    stats = ns.stats(seq_len=16)
    return ns.dvfs.LatencyAwareDVFSController(stats, ns.dvfs.no_early_exit_baseline(stats)["latency_s"] * 1.5)


LANE_FIELDS = ("admit_s", "deadline_s", "target_s", "cycles_per_layer", "depth", "energy_j",
               "pred_layers_remaining")


class TestCrossReplicaClockCheckpoint:
    def test_restore_on_either_replica_bit_identical(self):
        """A lane clock checkpointed on replica A restores on A and on B to
        the same lane state field for field (after the barrier both clocks
        agree); both packages give the same state."""
        out = {}
        for ns in (JAX, TORCH):
            ctrl = _ctrl(ns)
            arb_a, arb_b = ns.dvfs.BatchedDVFSArbiter(ctrl), ns.dvfs.BatchedDVFSArbiter(ctrl)
            arb_a.admit("lane", deadline_s=0.5)
            for _ in range(3):
                arb_a.step(["lane"])
            clk = arb_a.checkpoint_lane("lane")
            t = max(arb_a.now_s, arb_b.now_s)
            arb_a.advance_to(t)
            arb_b.advance_to(t)
            assert arb_a.now_s == arb_b.now_s
            arb_a.restore_lane("lane", copy.deepcopy(clk))
            arb_b.restore_lane("lane", copy.deepcopy(clk))
            sa, sb = arb_a._lanes["lane"], arb_b._lanes["lane"]
            for f in LANE_FIELDS:
                assert getattr(sa, f) == getattr(sb, f), f
            assert sa.slowest_op == sb.slowest_op
            out[ns.name] = ([getattr(sa, f) for f in LANE_FIELDS], arb_a.now_s,
                            (sa.slowest_op.vdd, sa.slowest_op.freq_hz))
        for a, b in zip(out["jax"][0], out["torch"][0]):
            if a is None or b is None:
                assert a is b is None
            else:
                _same_float(a, b, "lane")
        _same_float(out["jax"][1], out["torch"][1], "now_s")
        assert out["jax"][2] == out["torch"][2]

    def test_advance_to_is_monotone_noop_when_behind(self):
        def case(ns):
            arb = ns.dvfs.BatchedDVFSArbiter(_ctrl(ns))
            arb.advance_to(1.0)
            first = arb.now_s
            arb.advance_to(0.5)
            return first, arb.now_s

        assert _both(case) == (1.0, 1.0)

    def test_expanded_arbiters_share_controller_not_clocks(self):
        def case(ns):
            ctrl = _ctrl(ns)
            arbs = ns.engine._expand_arbiters(ns.dvfs.BatchedDVFSArbiter(ctrl), 3)
            assert len({id(a) for a in arbs}) == 3 and all(a.c is ctrl for a in arbs)
            arbs[0].admit("lane", deadline_s=0.5)
            arbs[0].step(["lane"])
            return len(arbs), arbs[0].now_s > 0.0, arbs[1].now_s, round(arbs[0].now_s, 15)

        assert _both(case)[:3] == (3, True, 0.0)
        with pytest.raises(ValueError, match="one arbiter per replica"):
            tengine._expand_arbiters([tdvfs.BatchedDVFSArbiter(_ctrl(TORCH))], 2)


# ===========================================================================
# per-replica admission quoting
# ===========================================================================


class _StubSharded:
    """A sharded-server facade over a bare LaneScheduler: the attributes the
    admission controller prices with (replicas, lane slabs)."""

    def __init__(self, sched, replicas, lanes_per_replica):
        self.sched = sched
        self.replicas = replicas
        self.lanes_per_replica = lanes_per_replica

    def submit(self, req):
        req.bucket = self.sched.submit(req)


class _HoldEngine:
    def __init__(self, lpr):
        self.lpr = lpr

    def bucket_key(self, req):
        return len(req.tokens)

    def lane_domain(self, lane):
        return lane // self.lpr

    def bucket_begin(self, bucket):
        pass

    def lane_load(self, bucket, lane, req):
        pass

    def lanes_step(self, bucket, active):
        return None

    def lane_advance(self, bucket, lane, req, out, depth):
        return False                 # contracts stay in flight

    def lane_finish(self, bucket, lane, req, depth):
        pass

    def bucket_end(self, bucket):
        pass


def _stub(ns, replicas=2, lpr=1):
    sched = ns.sched.LaneScheduler(replicas * lpr, _HoldEngine(lpr), buckets=(16,), step_time_fn=lambda b: 1.0)
    return _StubSharded(sched, replicas, lpr)


def _busy(ns):
    """A stub of 2 x 1 lanes with a long contract pinned to replica 0 in
    flight, and its admission controller."""
    srv = _stub(ns)
    ac = ns.adm.AdmissionController(srv, fallback_steps=2.0)
    busy = ns.engine.Request(uid=0, tokens=TOKS, deadline_s=50.0)
    busy.replica = 0
    assert ac.submit(busy).admitted
    srv.sched.step()
    return srv, ac


def _quote_tuple(q):
    return (q.bucket, q.replica, q.feasible, q.service_s, q.wait_s, q.min_deadline_s)


def _same_quotes(a, b):
    for qa, qb in zip(a, b):
        assert qa[:3] == qb[:3], (qa, qb)
        for x, y in zip(qa[3:], qb[3:]):
            _same_float(x, y, "quote")


class TestPerReplicaQuoting:
    def test_quotes_fan_out_and_route_least_loaded(self):
        out = {}
        for ns in (JAX, TORCH):
            srv, ac = _busy(ns)
            q = ac.quote(ns.engine.Request(uid=1, tokens=TOKS, deadline_s=1e9))
            q0 = ac.quote(ns.engine.Request(uid=2, tokens=TOKS, deadline_s=1e9), replica=0)
            assert q.replica == 1 and q.min_deadline_s < q0.min_deadline_s
            out[ns.name] = [_quote_tuple(q), _quote_tuple(q0)]
        _same_quotes(out["jax"], out["torch"])

    def test_accept_pins_request_to_quoted_replica(self):
        def case(ns):
            srv, ac = _busy(ns)
            req = ns.engine.Request(uid=1, tokens=TOKS, deadline_s=1e9)
            d = ac.submit(req)
            return d.admitted, d.quote.replica, req.replica

        assert _both(case) == (True, 1, 1)

    def test_single_replica_quote_unchanged(self):
        out = {}
        for ns in (JAX, TORCH):
            srv = _stub(ns, replicas=1, lpr=2)
            ac = ns.adm.AdmissionController(srv, fallback_steps=2.0)
            q = ac.quote(ns.engine.Request(uid=0, tokens=TOKS, deadline_s=1e9))
            d = ac.submit(ns.engine.Request(uid=1, tokens=TOKS, deadline_s=1e9))
            assert q.replica is None and d.admitted and getattr(d.quote, "replica", None) is None
            out[ns.name] = [_quote_tuple(q), _quote_tuple(d.quote)]
        _same_quotes(out["jax"], out["torch"])

    def test_real_sharded_classifier_quotes_per_replica(self):
        """The same fan-out on a port ClassifierServer of 2 x 1 CPU
        replicas: a contract pinned to replica 0 in flight, the next quote
        routes to replica 1, the accepted request is pinned there and lands
        on replica 1's lane; no accepted SLO missed."""
        c = _albert(0.5)
        model, params = c["torch"]
        stats = t_stats(seq_len=16)
        stats.n_layers = c["cfg"].n_layers
        ctrl = tdvfs.LatencyAwareDVFSController(stats, tdvfs.no_early_exit_baseline(stats)["latency_s"] * 1.5)
        srv = tengine.ClassifierServer(model, params, batch_lanes=1, buckets=(16,), replicas=2, device="cpu",
                                       arbiter=tdvfs.BatchedDVFSArbiter(ctrl))
        assert len(srv.arbiters) == 2 and srv.arbiters[0].c is srv.arbiters[1].c
        ac = tadm.AdmissionController(srv)
        q = ac.quote(tengine.Request(uid=0, tokens=TOKS, deadline_s=1e9))
        busy = tengine.Request(uid=0, tokens=TOKS, deadline_s=q.min_deadline_s * 4)
        busy.replica = 0
        assert ac.submit(busy).admitted
        srv.step()
        req = tengine.Request(uid=1, tokens=TOKS, deadline_s=1e9)
        d = ac.submit(req)
        assert d.admitted and d.quote.replica == 1 and req.replica == 1
        srv.step()
        assert srv.sched._open[16].lane_req[1] is req
        st = srv.run()
        assert st["accepted_slo_misses"] == 0 and st["accepted"] == 2


# ===========================================================================
# the device list: _resolve_devices
# ===========================================================================


class TestResolveDevices:
    def test_argument_rules(self):
        cpu = torch.device("cpu")
        assert tengine._resolve_devices(1, None, "cpu") == (1, [cpu])
        assert tengine._resolve_devices(3, None, "cpu") == (3, [cpu] * 3)
        assert tengine._resolve_devices(1, ["cpu", "cpu"], "cpu") == (2, [cpu] * 2)
        assert tengine._resolve_devices(2, ["cpu", "cpu"], "cuda") == (2, [cpu] * 2)
        with pytest.raises(ValueError, match="replicas"):
            tengine._resolve_devices(3, ["cpu", "cpu"], "cpu")
        with pytest.raises(ValueError, match="replicas"):
            tengine._resolve_devices(0, None, "cpu")
        with pytest.raises(ValueError):
            tengine._resolve_devices(1, [], "cpu")

    def test_one_card_named_twice(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        r, devs = tengine._resolve_devices(1, ["cuda:0", "cuda:0"], "cuda")
        assert r == 2 and devs == [torch.device("cuda", 0)] * 2
        with pytest.raises(RuntimeError, match="1 CUDA devices"):
            tengine._resolve_devices(1, ["cuda:0", "cuda:1"], "cuda")

    def test_two_replicas_without_a_list_raise_on_one_card(self, monkeypatch):
        """replicas=2 with no device list on a machine with one card raises,
        in the helper and in both servers: replicas are never stacked on
        one card unasked."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="replicas=2 needs 2 CUDA devices"):
            tengine._resolve_devices(2, None, "cuda")
        c = _albert(0.5)
        with pytest.raises(RuntimeError, match="replicas=2 needs 2 CUDA devices"):
            tengine.ClassifierServer(*c["torch"], replicas=2)
        d = _plain_models("deepseek_7b")
        with pytest.raises(RuntimeError, match="replicas=2 needs 2 CUDA devices"):
            tengine.DecoderServer(*d["torch"], replicas=2)

    def test_cuda_without_a_card_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine._resolve_devices(2, None, "cuda")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tengine._resolve_devices(1, ["cuda:0"], "cpu")


def test_replicas_share_params_per_device():
    """One params copy (and one set of block masks) per distinct device:
    replicas on one device read the same tensors."""
    c = _albert(0.5, span=False, prune=True)
    srv = tengine.ClassifierServer(*c["torch"], batch_lanes=1, replicas=3, device="cpu")
    p0, p2 = srv._rparams[0]["layer"]["mlp"]["w_up"], srv._rparams[2]["layer"]["mlp"]["w_up"]
    assert p0.data_ptr() == p2.data_ptr()
    assert srv._block_masks[0] is srv._block_masks[2]
    assert srv._block_masks[0]["w_up"].indices.device.type == "cpu"


def test_serve_sharded_launcher():
    """launch.serve_sharded on CPU replicas: contracts admitted at their own
    quote and placed across the replicas, one build per (bucket, replicas),
    no accepted SLO missed, every domain's clock at the fleet's."""
    out = serve_sharded.main(["--smoke", "--device", "cpu"])
    assert out["replicas"] == 2 and out["devices"] == ["cpu", "cpu"]
    assert out["accepted"] == 4 and out["accepted_slo_misses"] == 0
    assert set(out["step_traces_per_bucket_replica"].values()) == {1}
    assert all(k.endswith("x2") for k in out["step_traces_per_bucket_replica"])
    assert {r for _, r in out["placement"]} <= {0, 1}
    clocks = {d["clock_s"] for d in out["domains"]}
    assert len(clocks) == 1 and all(d["energy_j"] > 0 for d in out["domains"])
    out = serve_sharded.main(["--smoke", "--device", "cpu", "--devices", "cpu,cpu,cpu"])
    assert out["replicas"] == 3 and out["accepted_slo_misses"] == 0
