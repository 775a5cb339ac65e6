"""Classifier serving, port against the JAX package.

The JAX package initialises the smoke ``albert_edgebert`` params (float32);
the weight bridge brings them across.  Three variants: the shipped config
(trained soft spans, so serving attention stays on the reference ops), span
disabled (attention goes to the span kernel at full window with per-lane
kv_len), and span disabled with the MLP weights block-pruned at the
config's 32x32 tiles (the block-sparse kernel takes the MLP).  The exit
threshold comes from a full-depth profiling drain, at least 1e-3 from
every observed entropy, so float32 noise cannot flip an exit.

On the CPU the port's kernel route runs each kernel's plain version; the
JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``).

Tolerances: logits atol 2e-4, the JAX package's own bound between its two
routes (float32 sums in another order).  Activation quantization turns a
last-ulp difference at an AdaptivFloat rounding boundary into one whole
quantum; the requests below (SyntheticCLS seed 2) are ones on which no
element lands on such a boundary in any variant, so the bound holds
(PERF.md records the full-width case on the card).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.early_exit import fit_exit_predictor as j_fit
from repro.core.pruning import magnitude_mask as j_magnitude_mask
from repro.data.synthetic import SyntheticCLS as JSyntheticCLS
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving.engine import ClassifierServer as JServer
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.early_exit import fit_exit_predictor as t_fit
from repro_torch.data.synthetic import SyntheticCLS
from repro_torch.kernels import dispatch
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving.engine import ClassifierServer, Request

ATOL = 2e-4
BUCKETS = (16, 32)
LENGTHS = [12, 16, 9, 24, 32, 16, 27, 12]
VARIANTS = {"span": (True, False), "nospan": (False, False), "pruned": (False, True)}
TELEMETRY_EQUAL = ("sentences", "layer_calls", "dense_steps", "bucket_steps", "buckets_used",
                   "lane_occupancy", "queue_delay_steps_p50", "queue_delay_steps_p95",
                   "queue_delay_steps_p99", "queue_delay_steps_max", "step_traces",
                   "embed_traces", "insert_traces", "step_traces_per_bucket", "preemptions")


def _cfgs(span, threshold):
    out = []
    for get in (j_smoke, t_smoke):
        c = dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
        out.append(c.with_edgebert(
            early_exit=dataclasses.replace(c.edgebert.early_exit, entropy_threshold=threshold),
            span=dataclasses.replace(c.edgebert.span, enabled=span)))
    return out


def _tokens(cfg, n=8, seed=2):
    batch = JSyntheticCLS(cfg.vocab_size, 32, n, num_classes=3, seed=seed).batch(0)
    np.testing.assert_array_equal(
        SyntheticCLS(cfg.vocab_size, 32, n, num_classes=3, seed=seed).batch(0)["tokens"],
        batch["tokens"])
    return [batch["tokens"][i][: LENGTHS[i % len(LENGTHS)]] for i in range(n)]


def _pick_threshold(entropies, min_gap=1e-3):
    """Midpoint of the gap nearest the median that is wider than 2 * min_gap."""
    e = np.unique(np.asarray(entropies, np.float64))
    mids = [(a + b) / 2 for a, b in zip(e, e[1:]) if b - a > 2 * min_gap]
    assert mids, "no gap wide enough between observed entropies"
    return float(min(mids, key=lambda m: abs(m - np.median(e))))


def _drain(server, tokens, deadlines=None):
    R = JRequest if isinstance(server, JServer) else Request
    for i, t in enumerate(tokens):
        server.submit(R(uid=i, tokens=t, deadline_s=None if deadlines is None else deadlines[i]))
    server.run()
    return server


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    span, prune = VARIANTS[request.param]
    jcfg, _ = _cfgs(span, 0.0)
    jparams = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    if prune:
        mlp = dict(jparams["layer"]["mlp"])
        for name in ("w_up", "w_down"):
            mlp[name] = mlp[name] * j_magnitude_mask(
                mlp[name], jcfg.edgebert.prune.encoder_sparsity, block_size=32)
        jparams = dict(jparams, layer=dict(jparams["layer"], mlp=mlp))
    assert ("span_z" in jparams) == span
    tokens = _tokens(jcfg)
    prof = _drain(JServer(j_build(jcfg), jparams, batch_lanes=4, buckets=BUCKETS), tokens)
    traces = [prof.done[i].entropy_trace for i in range(len(tokens))]
    thr = _pick_threshold(np.concatenate(traces))
    jcfg, tcfg = _cfgs(span, thr)
    jsrv = _drain(JServer(j_build(jcfg), jparams, batch_lanes=4, buckets=BUCKETS, use_pallas=True),
                  tokens)
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jparams=jparams, tokens=tokens,
                np_params=jax.tree_util.tree_map(np.asarray, jparams), traces=traces, jsrv=jsrv)


def _port_server(v, **kw):
    return ClassifierServer(t_build(v["tcfg"]), params_from_numpy(v["np_params"], device="cpu"),
                            batch_lanes=4, buckets=BUCKETS, device="cpu", **kw)


def _assert_same_drain(tsrv, jsrv, n, n_layers):
    for i in range(n):
        assert tsrv.done[i].exit_layer == jsrv.done[i].exit_layer, i
        np.testing.assert_allclose(tsrv.done[i].result, np.asarray(jsrv.done[i].result), atol=ATOL)
        np.testing.assert_allclose(tsrv.done[i].entropy_trace, jsrv.done[i].entropy_trace, atol=1e-5)
    depths = {jsrv.done[i].exit_layer for i in range(n)}
    assert min(depths) < n_layers and len(depths) > 1     # the threshold splits the mix
    tt, tj = tsrv.telemetry(), jsrv.telemetry()
    for k in TELEMETRY_EQUAL:
        assert tt[k] == tj[k], k
    assert tt["avg_exit_layer"] == pytest.approx(tj["avg_exit_layer"], rel=1e-12)
    assert tt["step_traces"] == len(tj["step_traces_per_bucket"]) <= len(BUCKETS)


def test_drain_matches_jax(variant, monkeypatch):
    """use_kernels=True against the JAX package's use_pallas=True: exits
    equal, logits within 2e-4, scheduler telemetry equal; and the kernel
    route takes the ops its eligibility rules give it."""
    calls = {name: 0 for name in ("layernorm", "offramp_head", "act_quantize", "dense_attention",
                                  "sparse_matmul")}
    for name in calls:
        orig = getattr(dispatch, name)

        def counting(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(dispatch, name, counting)
    tsrv = _drain(_port_server(variant), variant["tokens"])
    _assert_same_drain(tsrv, variant["jsrv"], len(variant["tokens"]), variant["tcfg"].n_layers)
    steps = tsrv.telemetry()["dense_steps"]
    assert calls["layernorm"] == 2 * steps
    assert calls["offramp_head"] == calls["act_quantize"] == steps
    assert calls["dense_attention"] == (0 if variant["name"] == "span" else steps)
    assert calls["sparse_matmul"] == (2 * steps if variant["name"] == "pruned" else 0)


def test_reference_route_drain_matches_jax(variant):
    """use_kernels=False against the JAX package's use_pallas=False."""
    v = variant
    jsrv = _drain(JServer(j_build(v["jcfg"]), v["jparams"], batch_lanes=4, buckets=BUCKETS),
                  v["tokens"])
    tsrv = _drain(_port_server(v, use_kernels=False), v["tokens"])
    _assert_same_drain(tsrv, jsrv, len(v["tokens"]), v["tcfg"].n_layers)


def _controllers(v):
    traces = v["traces"]
    n_layers = v["tcfg"].n_layers
    thr = v["tcfg"].edgebert.early_exit.entropy_threshold
    first = np.array([t[0] for t in traces])
    exits = np.array([next((i + 1 for i, e in enumerate(t) if e < thr), n_layers) for t in traces])
    target = jdvfs.no_early_exit_baseline(jdvfs.albert_layer_stats(seq_len=32))["latency_s"]
    jctl = jdvfs.default_albert_controller(target, seq_len=32, n_layers=n_layers,
                                           predictor=j_fit(first, exits, n_bins=4))
    tctl = tdvfs.default_albert_controller(target, seq_len=32, n_layers=n_layers,
                                           predictor=t_fit(first, exits, n_bins=4))
    # the predictor bins the first entropy: keep it away from every bin edge
    assert np.min(np.abs(first[:, None] - tctl.predictor.bin_edges[None])) > 1e-4
    return jctl, tctl, target


def test_drain_with_arbiter_matches_jax(variant):
    """Shared-clock DVFS: the modeled energy, switches and misses, per
    request and in telemetry, equal to 1e-9 relative; some requests carry
    explicit SLOs, one of them too tight to meet."""
    v = variant
    jctl, tctl, target = _controllers(v)
    deadlines = [None, 0.9 * target, None, 2.0 * target, None, 0.02 * target, None, 1.5 * target]
    jsrv = _drain(JServer(j_build(v["jcfg"]), v["jparams"], batch_lanes=4, buckets=BUCKETS,
                          use_pallas=True, arbiter=jdvfs.BatchedDVFSArbiter(jctl)),
                  v["tokens"], deadlines)
    tsrv = _drain(_port_server(v, arbiter=tdvfs.BatchedDVFSArbiter(tctl)), v["tokens"], deadlines)
    _assert_same_drain(tsrv, jsrv, len(v["tokens"]), v["tcfg"].n_layers)
    tt, tj = tsrv.telemetry(), jsrv.telemetry()
    for k in ("op_switches", "deadline_misses", "accepted_slo_misses"):
        assert tt[k] == tj[k], k
    for k in ("energy_j", "modeled_latency_s", "switch_energy_j", "switch_time_s", "arb_energy_j"):
        assert tt[k] == pytest.approx(tj[k], rel=1e-9, abs=0.0), k
    assert tj["deadline_misses"] >= 1 and tj["op_switches"] >= 1
    for i in range(len(v["tokens"])):
        a, b = tsrv.done[i], jsrv.done[i]
        for f in ("energy_j", "latency_s", "op_vdd", "op_freq_hz", "arrival_s", "admit_s", "retire_s"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-9, abs=1e-15), (i, f)


def test_drain_with_per_sentence_dvfs_matches_jax(variant):
    v = variant
    jctl, tctl, _ = _controllers(v)
    jsrv = _drain(JServer(j_build(v["jcfg"]), v["jparams"], batch_lanes=4, buckets=BUCKETS,
                          dvfs=jctl), v["tokens"])
    tsrv = _drain(_port_server(v, dvfs=tctl), v["tokens"])
    _assert_same_drain(tsrv, jsrv, len(v["tokens"]), v["tcfg"].n_layers)
    assert tsrv.telemetry()["energy_j"] == pytest.approx(jsrv.telemetry()["energy_j"], rel=1e-9)


@pytest.mark.parametrize("S", [16, 32])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("span", [True, False])
def test_dense_layer_step_matches_jax(use_kernels, span, S):
    """One shared encoder layer on three right-padded lanes, against the JAX
    package's one-lane body (its serving step's vmap) with the same flag:
    atol 1e-5.  Spans of 2-30 tokens make the soft ramp bite; S = 16 takes
    the single-softmax branch, S = 32 the chunked one.  The reference route
    keeps fake_quant's x + (q - x), the kernel route returns q, on both
    sides."""
    jcfg, tcfg = _cfgs(span, 0.3)
    jparams = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    if span:
        jparams = dict(jparams, span_z=jnp.asarray([[2.0, 5.5, 9.0, 30.0]], jnp.float32))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    lanes = 3
    h = np.random.default_rng(3).standard_normal((lanes, S, jcfg.d_model)).astype(np.float32)
    kv = np.array([S, S // 2 + 1, 5], np.int32)
    jm, tm = j_build(jcfg), t_build(tcfg)

    def one_lane(h_l, kv_l):
        return jm._dense_layer_step(jparams["layer"], h_l[None], causal=False,
                                    span_z=jm._span_for_layer(jparams, 0), kv_len=kv_l,
                                    use_pallas=use_kernels)[0][0]

    want = np.asarray(jax.vmap(one_lane)(jnp.asarray(h), jnp.asarray(kv)))
    got = tm._dense_layer_step(tparams["layer"], torch.from_numpy(h), causal=False,
                               span_z=tm._span_for_layer(tparams, 0), kv_len=torch.from_numpy(kv),
                               use_kernels=use_kernels, per_lane=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_preempt_restore_bit_identical():
    """A drain that checkpoints a lane for a tight explicit SLO and restores
    it later gives the same exits and bit-identical logits as the same
    requests run uninterrupted (tests/test_pallas_serving.py's case)."""
    _, tcfg = _cfgs(True, 1e-9)
    params = t_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks = SyntheticCLS(tcfg.vocab_size, 32, 8, num_classes=3, seed=0).batch(0)["tokens"]
    srv = ClassifierServer(t_build(tcfg), params, batch_lanes=2, buckets=(16,), preempt=True,
                           device="cpu")
    ref = ClassifierServer(t_build(tcfg), params, batch_lanes=2, buckets=(16,), device="cpu")
    for s in (srv, ref):
        for i in range(3):
            s.submit(Request(uid=i, tokens=toks[i][:12]))
    srv.step()
    srv.step()
    srv.submit(Request(uid=99, tokens=toks[4][:12], deadline_s=float(tcfg.n_layers + 3)))
    while srv.step() is not None:
        pass
    while ref.step() is not None:
        pass
    st, st_ref = srv.telemetry(), ref.telemetry()
    assert st["preemptions"] >= 1 and st["restored_steps_saved"] >= 1
    assert any(srv.done[i].preempted for i in range(3))
    for i in range(3):
        assert srv.done[i].exit_layer == ref.done[i].exit_layer, i
        assert np.array_equal(srv.done[i].result, ref.done[i].result), i
    assert st["step_traces"] == st_ref["step_traces"] == 1
    assert st["insert_traces"] == st_ref["insert_traces"] == 1


def test_apply_train_matches_jax():
    """The dense all-layers forward (the profiling pass): every off-ramp's
    entropy within 1e-5, logits within 1e-4, exit layers equal."""
    jcfg, tcfg = _cfgs(True, 1.03)
    jparams = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jo = j_build(jcfg).apply_train(jparams, {"tokens": jnp.asarray(tokens)})
    to = t_build(tcfg).apply_train(tparams, {"tokens": tokens})
    np.testing.assert_allclose(to.all_entropies.numpy(), np.asarray(jo.all_entropies), atol=1e-5)
    np.testing.assert_allclose(to.all_cls_logits.numpy(), np.asarray(jo.all_cls_logits), atol=1e-4)
    np.testing.assert_array_equal(to.exit_layer.numpy(), np.asarray(jo.exit_layer))


def test_serve_launcher_on_the_cpu():
    stats = serve.main(["--smoke", "--device", "cpu", "--requests", "6", "--seq", "16",
                        "--lanes", "2"])
    assert stats["sentences"] == 6 and stats["step_traces"] == 1
    assert 1 <= stats["avg_exit_layer"] <= t_smoke("albert_edgebert").n_layers


def test_server_refuses_both_dvfs_modes():
    _, tcfg = _cfgs(True, 0.3)
    ctl = tdvfs.default_albert_controller(1e-3, seq_len=16, n_layers=tcfg.n_layers)
    params = t_init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        ClassifierServer(t_build(tcfg), params, dvfs=ctl, arbiter=tdvfs.BatchedDVFSArbiter(ctl),
                         device="cpu")


@pytest.mark.parametrize("causal", [False, True])
def test_span_soft_mask_matches_jax(causal):
    """The soft span ramp (paper §III-B) over [heads, q, k], atol 0: the same
    float32 arithmetic on small integers and spans."""
    from repro.core.adaptive_span import span_soft_mask as j_mask
    from repro_torch.core.adaptive_span import span_soft_mask

    z = np.array([0.0, 3.5, 17.0, 64.0], np.float32)
    want = np.asarray(j_mask(jnp.asarray(z), 9, 40, ramp=8, causal=causal, q_offset=5))
    got = span_soft_mask(torch.from_numpy(z), 9, 40, ramp=8, causal=causal, q_offset=5).numpy()
    np.testing.assert_array_equal(got, want)


def test_predicted_remaining_layers_matches_jax():
    from repro.core.early_exit import predicted_remaining_layers as j_remaining
    from repro_torch.core.early_exit import predicted_remaining_layers

    def predict(e):
        return 2.0 + 10.0 * e

    for trace in ([], [0.05], [0.3, 0.2], [0.9, 0.8, 0.7]):
        for depth in range(0, 13):
            for fn in (None, predict):
                assert predicted_remaining_layers(trace, depth, 12, predict_fn=fn) == \
                    j_remaining(trace, depth, 12, predict_fn=fn)
