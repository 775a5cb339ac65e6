"""The port's encoder family (ModernBERT-large's early-exit classifier) at
smoke size on the CPU, against the plain float32 reference
``tests/modernbert_ref.py`` (which imports nothing of the port), and the
reference against ``transformers``' ModernBERT where it is installed.

Tolerances: the port's LayerNorm takes its variance as E[x^2] - E[x]^2
(the layernorm kernel's form) where the reference takes the two-pass
form, and sums run in other orders, so float32 values differ by a few
1e-7 relative; the AdaptivFloat grid (4 mantissa bits) can turn such a
difference into one grid step where a value lies on a rounding boundary.
The seeds here give no such flip, and every threshold sits midway in the
widest gap between the reference's entropies, so the exit layers agree
exactly."""
import dataclasses

import numpy as np
import pytest
import torch

import modernbert_ref as R
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.kernels import dispatch
from repro_torch.models import layers as L
from repro_torch.models.model import build_model, init_params
from repro_torch.serving.engine import ClassifierServer, Request

torch.set_num_threads(1)

BUCKETS = (16, 32, 48)
LENGTHS = (40, 33, 20, 48, 12, 30, 45, 7, 26, 17, 38, 9, 29, 44)


def smoke(quant=True):
    cfg = get_smoke_config("modernbert_large")
    return cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, enabled=quant))


def ref_model(cfg):
    q = cfg.edgebert.quant
    return {"n_layers": cfg.n_layers, "n_heads": cfg.n_heads, "head_dim": cfg.head_dim, "norm_eps": cfg.norm_eps,
            "global_every": cfg.global_every, "local_window": cfg.local_window, "rope_theta": cfg.rope_theta,
            "local_rope_theta": cfg.local_rope_theta,
            "quant": {"n_bits": q.n_bits, "n_exp": q.n_exp} if q.enabled and q.quantize_activations else None}


def weights(cfg, seed=0):
    """The port's tree with the norms' scales and the classifier biases
    drawn away from their init (ones, zeros), and the MLP pruned to 0.5 in
    32 x 32 tiles (as the served configuration is)."""
    p = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)

    def jitter(node):
        for k, v in node.items():
            if isinstance(v, dict):
                jitter(v)
            elif k == "scale":
                node[k] = 1.0 + 0.2 * torch.randn(v.shape, generator=g)
    jitter(p)
    p["offramps"]["cls_b"] = 0.1 * torch.randn(p["offramps"]["cls_b"].shape, generator=g)
    for name in ("w_up", "w_down"):
        w = p["layers"]["mlp"][name]
        tiles = w.abs().reshape(w.shape[0], w.shape[1] // 32, 32, w.shape[2] // 32, 32).sum(dim=(2, 4))
        keep = tiles > tiles.flatten(1).median(dim=1).values[:, None, None]
        p["layers"]["mlp"][name] = w * keep.repeat_interleave(32, 1).repeat_interleave(32, 2)
    return p


def docs(cfg, seed=3, lengths=LENGTHS):
    g = np.random.default_rng(seed)
    return [g.integers(3, cfg.vocab_size, n).astype(np.int32) for n in lengths]


def padded(toks, S):
    x = np.zeros((len(toks), S), np.int64)
    for i, t in enumerate(toks):
        x[i, :len(t)] = t
    return torch.as_tensor(x), torch.as_tensor([len(t) for t in toks])


def ref_by_bucket(cfg, p, toks):
    """The reference's off-ramp logits [N, L, C] and entropies [N, L], each
    document padded to its own bucket."""
    m = ref_model(cfg)
    lg = np.zeros((len(toks), cfg.n_layers, 3))
    ent = np.zeros((len(toks), cfg.n_layers))
    with torch.no_grad():
        for i, t in enumerate(toks):
            x, n = padded([t], min(b for b in BUCKETS if b >= len(t)))
            l, e = R.traces(p, x, n, m)
            lg[i], ent[i] = l[:, 0].numpy(), e[:, 0].numpy()
    return lg, ent


def mid_threshold(ent, lo=0.3, hi=0.7):
    """A threshold midway in the widest gap between the entropies of the
    layers before the last, among those between their ``lo`` and ``hi``
    quantiles: exits are mixed, and no entropy lies near it."""
    v = np.sort(ent[:, :-1].ravel())
    v = v[int(lo * len(v)):int(hi * len(v))]
    j = int(np.argmax(np.diff(v)))
    return float((v[j] + v[j + 1]) / 2)


def with_threshold(cfg, thr):
    return cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=thr))


def to_hf(p, cfg):
    """The port's tree as ``transformers``' ModernBertForSequenceClassification
    state: Wqkv is [wq | wk | wv] transposed, every Linear's weight the
    port's matrix transposed, the last off-ramp the final norm, head and
    classifier."""
    Lr = cfg.n_layers - 1
    sd = {"model.embeddings.tok_embeddings.weight": p["embed"]["tok"],
          "model.embeddings.norm.weight": p["embed"]["norm"]["scale"],
          "model.final_norm.weight": p["offramps"]["norm"]["scale"][Lr],
          "head.dense.weight": p["offramps"]["dense"][Lr].T, "head.norm.weight": p["offramps"]["head_norm"]["scale"][Lr],
          "classifier.weight": p["offramps"]["cls_w"][Lr].T, "classifier.bias": p["offramps"]["cls_b"][Lr]}
    ly = p["layers"]
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        if i:
            sd[pre + "attn_norm.weight"] = ly["attn_norm"]["scale"][i]
        a = ly["attn"]
        sd[pre + "attn.Wqkv.weight"] = torch.cat([a["wq"][i], a["wk"][i], a["wv"][i]], dim=1).T
        sd[pre + "attn.Wo.weight"] = a["wo"][i].T
        sd[pre + "mlp_norm.weight"] = ly["mlp_norm"]["scale"][i]
        sd[pre + "mlp.Wi.weight"] = ly["mlp"]["w_up"][i].T
        sd[pre + "mlp.Wo.weight"] = ly["mlp"]["w_down"][i].T
    return {k: v.contiguous() for k, v in sd.items()}


def test_reference_matches_transformers():
    """The plain reference (quantization off: the published model has none)
    against ``transformers``' ModernBERT with the same weights, on
    unpadded documents: every layer's output within 2e-5 of the hidden
    state's magnitude and the classifier's logits within 2e-5 (sum orders;
    both float32)."""
    tr = pytest.importorskip("transformers")
    cfg = smoke(quant=False)
    p = weights(cfg)
    hc = tr.ModernBertConfig(vocab_size=cfg.vocab_size, hidden_size=cfg.d_model, intermediate_size=cfg.d_ff,
                             num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
                             max_position_embeddings=cfg.max_seq_len, norm_eps=cfg.norm_eps, norm_bias=False,
                             global_rope_theta=cfg.rope_theta, local_rope_theta=cfg.local_rope_theta,
                             global_attn_every_n_layers=cfg.global_every, local_attention=cfg.local_window,
                             num_labels=3, classifier_pooling="cls", reference_compile=False,
                             attn_implementation="sdpa", pad_token_id=0, bos_token_id=1, eos_token_id=2,
                             cls_token_id=1, sep_token_id=2)
    hf = tr.ModernBertForSequenceClassification(hc).eval()
    missing, unexpected = hf.load_state_dict(to_hf(p, cfg), strict=False)
    assert not unexpected and not [k for k in missing if "rotary" not in k], (missing, unexpected)
    m = ref_model(cfg)
    for n in (48, 29):
        x = torch.as_tensor(docs(cfg, 5, (n,))[0], dtype=torch.long)[None]
        with torch.no_grad():
            out = hf(input_ids=x, output_hidden_states=True)
            hs = out.hidden_states
            h = R.embed(p, x, m)
            torch.testing.assert_close(h, hs[0], atol=2e-5, rtol=0)
            for i in range(cfg.n_layers):
                h = R.quantize_slab(R.layer_pre(p, i, h, torch.tensor([n]), m), m)
                if i + 1 < cfg.n_layers:
                    scale = float(hs[i + 1].abs().max())
                    torch.testing.assert_close(h, hs[i + 1], atol=2e-5 * scale, rtol=0)
            torch.testing.assert_close(R.offramp(p, cfg.n_layers - 1, h[:, 0], m), out.logits, atol=2e-5, rtol=0)


def test_forward_encoder_matches_reference():
    """``Model.apply_train`` (the all-layers pass with an off-ramp after each
    layer) on a padded batch against the reference: exit layers exact,
    every off-ramp's entropy within 2e-5 and logits within 1e-4."""
    cfg = smoke()
    p = weights(cfg)
    toks = docs(cfg)[:6]
    x, n = padded(toks, 48)
    with torch.no_grad():
        lg, ent = R.traces(p, x, n, ref_model(cfg))
    cfg = with_threshold(cfg, mid_threshold(ent.T.numpy()))
    with torch.no_grad():
        out = build_model(cfg).apply_train(p, {"tokens": x, "lengths": n})
    np.testing.assert_array_equal(out.exit_layer.numpy(), R.exit_layers(ent.clone(), cfg.edgebert.early_exit.entropy_threshold).numpy())
    assert len(set(out.exit_layer.tolist())) > 1
    torch.testing.assert_close(out.all_entropies, ent, atol=2e-5, rtol=0)
    torch.testing.assert_close(out.all_cls_logits, lg, atol=1e-4, rtol=0)


def drain(cfg, p, toks, lanes=4, use_kernels=True, **kw):
    srv = ClassifierServer(build_model(cfg), p, batch_lanes=lanes, buckets=BUCKETS, device="cpu",
                           use_kernels=use_kernels, **kw)
    for i, t in enumerate(toks):
        srv.submit(Request(uid=i, tokens=t))
    srv.run()
    return srv


@pytest.mark.parametrize("use_kernels", [True, False])
def test_server_drain_at_mixed_depths_matches_reference(use_kernels):
    """A ``ClassifierServer`` drain over 14 documents in 4 lanes: refills
    leave the lanes at different depths, so steps run several depth groups,
    each lane its own layer's weights and off-ramp.  Every document against
    the reference at its own bucket: exit layer exact, entropy trace within
    2e-5, logits within 1e-4.  The telemetry counts each lane-layer once,
    by its kind of attention."""
    cfg = smoke()
    p = weights(cfg)
    toks = docs(cfg)
    lg, ent = ref_by_bucket(cfg, p, toks)
    thr = mid_threshold(ent)
    srv = drain(with_threshold(cfg, thr), p, toks, use_kernels=use_kernels)
    exits = R.exit_layers(torch.as_tensor(ent.T), thr).numpy()
    assert len(set(exits.tolist())) >= 3
    for i in range(len(toks)):
        req = srv.done[i]
        assert req.exit_layer == exits[i], i
        np.testing.assert_allclose(req.entropy_trace, ent[i, :exits[i]], atol=2e-5)
        np.testing.assert_allclose(req.result, lg[i, exits[i] - 1], atol=1e-4)
    tel = srv.telemetry()
    assert tel["depth_groups"] > tel["dense_steps"]          # some step ran lanes at two depths
    assert tel["lane_layers_global"] + tel["lane_layers_local"] == tel["layer_calls"] == exits.sum()
    n_global = sum(1 for e in exits for i in range(e) if i % cfg.global_every == 0)
    assert tel["lane_layers_global"] == n_global


def test_window_edge_sees_half_the_window_and_not_one_more():
    """A local layer's key j is visible to query i when |i - j| <= 64 at
    full size (the span kernel's window 65): with uniform queries and v one
    at a single key, a query at distance 64 reads 1 / (keys it sees) and
    one at 65 reads 0, on the port's reference ops, on the span kernel's
    plain version (the card's rule) and on the plain reference.  The smoke
    window (8: 4 each side) the same."""
    for cfg in (get_config("modernbert_large"), smoke()):
        half = cfg.local_window // 2
        window = half + 1                     # the port's: |i - j| < window
        S, j = 4 * half + 8, 2 * half + 4
        q = torch.zeros(1, S, 1, 64)
        k = torch.zeros(1, S, 1, 64)
        v = torch.zeros(1, S, 1, 64)
        v[0, j, 0, :] = 1.0
        kv = torch.tensor([S])
        seen = {"reference ops": L.attention(q, k, v, causal=False, kv_len=kv, window=window),
                "span kernel": dispatch.dense_attention(q, k, v, causal=False, kv_len=kv, window=window),
                "plain reference": R.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv,
                                               half).transpose(1, 2)}
        for name, out in seen.items():
            for i, visible in ((j - half, True), (j + half, True), (j - half - 1, False), (j + half + 1, False)):
                lo, hi = max(0, i - half), min(S, i + half + 1)
                want = 1.0 / (hi - lo) if visible else 0.0
                assert float(out[0, i, 0, 0]) == pytest.approx(want, abs=1e-7), (cfg.name, name, i)


def test_layer0_norm_is_the_identity_and_gelu_is_exact():
    """Layer 0 applies no attention norm (ModernBERT's ``nn.Identity``):
    its attn_norm scale changes nothing, layer 1's changes the output.  The
    GeGLU MLP's GELU is the exact erf form, not the tanh form (they differ
    by up to ~5e-4 at |x| ~ 2)."""
    cfg = smoke(quant=False)
    model = build_model(cfg)
    p = weights(cfg)
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(7))

    def run(i, scale):
        lp = model._layer(p, i)[0]
        lp = dict(lp, attn_norm={"scale": torch.full_like(lp["attn_norm"]["scale"], scale)})
        return model.encoder_layer_step(lp, h, layer=i)

    assert torch.equal(run(0, 1.0), run(0, 3.0))
    assert not torch.allclose(run(1, 1.0), run(1, 3.0))

    x = 2.0 * torch.randn(3, 8, cfg.d_model, generator=torch.Generator().manual_seed(8))
    mlp = {"w_up": p["layers"]["mlp"]["w_up"][0], "w_down": p["layers"]["mlp"]["w_down"][0]}
    a, g = (x @ mlp["w_up"]).chunk(2, dim=-1)
    erf = (0.5 * a * (1.0 + torch.erf(a / np.sqrt(2.0))) * g) @ mlp["w_down"]
    tanh = (torch.nn.functional.gelu(a, approximate="tanh") * g) @ mlp["w_down"]
    got = L.apply_mlp(mlp, x, act="geglu")
    torch.testing.assert_close(got, erf, atol=1e-5, rtol=1e-5)
    assert (got - tanh).abs().max() > 1e-4


def _contracts_drain(cfg, p, toks):
    """Two lanes, the last document an explicit-deadline contract submitted
    after two steps: it evicts a lane at depth 2."""
    srv = ClassifierServer(build_model(cfg), p, batch_lanes=2, buckets=BUCKETS, device="cpu", preempt=True)
    for i, t in enumerate(toks[:-1]):
        srv.submit(Request(uid=i, tokens=t))
    srv.step()
    srv.step()
    srv.submit(Request(uid=len(toks) - 1, tokens=toks[-1], deadline_s=float(cfg.n_layers + 3)))
    while srv.step() is not None:
        pass
    return srv


def test_checkpoint_and_restore_mid_depth_are_bit_for_bit():
    """A lane checkpointed at depth 2, its state then overwritten, and
    restored into its lane gives every document the result, exit and
    entropy trace of an uninterrupted drain bit for bit.  Under preemption
    the evicted document resumes at its depth (the scheduler's, carried by
    the request) in whichever lane: no layer runs twice, every exit equals
    the uninterrupted drain's, results within 1e-5 (a lane's rows run in
    depth groups of other sizes then, and a matrix product's rounding on
    the CPU follows its row count)."""
    cfg = smoke()
    p = weights(cfg)
    toks = docs(cfg, lengths=(40, 33, 45, 38, 41))
    _, ent = ref_by_bucket(cfg, p, toks)
    thr = mid_threshold(ent, 0.05, 0.2)
    # the deepest first: both lanes are still busy when the contract comes
    order = np.argsort(-R.exit_layers(torch.as_tensor(ent.T), thr).numpy(), kind="stable")
    toks = [toks[i] for i in order]
    cfg = with_threshold(cfg, thr)
    plain = drain(cfg, p, toks, lanes=2)

    srv = ClassifierServer(build_model(cfg), p, batch_lanes=2, buckets=BUCKETS, device="cpu")
    for i, t in enumerate(toks):
        srv.submit(Request(uid=i, tokens=t))
    srv.step()
    srv.step()
    req = srv.sched._open[48].lane_req[1]
    assert srv.sched.lane_depths(48)[1] == 2
    payload = srv.lane_checkpoint(48, 1, req)
    srv._bstate[48]["h"][0][1] = 0.0
    srv.lane_restore(48, 1, req, payload)
    while srv.step() is not None:
        pass
    for i in range(len(toks)):
        a, b = srv.done[i], plain.done[i]
        assert a.exit_layer == b.exit_layer, i
        assert np.array_equal(a.result, b.result) and a.entropy_trace == b.entropy_trace, i

    pre = _contracts_drain(cfg, p, toks)
    tel = pre.telemetry()
    assert tel["preemptions"] >= 1 and tel["restored_steps_saved"] >= 2
    assert any(pre.done[i].preempted for i in range(len(toks)))
    assert tel["layer_calls"] == sum(pre.done[i].exit_layer for i in range(len(toks)))
    for i in range(len(toks)):
        a, b = pre.done[i], plain.done[i]
        assert a.exit_layer == b.exit_layer, i
        np.testing.assert_allclose(a.result, b.result, atol=1e-5)
        np.testing.assert_allclose(a.entropy_trace, b.entropy_trace, atol=1e-5)


def test_step_reads_the_schedulers_depth():
    """The engine keeps no depth of its own: it runs each lane at the
    scheduler's ``lane_depths``, so a depth moved there moves the layer the
    lane runs (and the layer log records it)."""
    cfg = with_threshold(smoke(), -1.0)
    p = weights(cfg)
    srv = ClassifierServer(build_model(cfg), p, batch_lanes=2, buckets=BUCKETS, device="cpu")
    for i, t in enumerate(docs(cfg, lengths=(20, 24))):
        srv.submit(Request(uid=i, tokens=t))
    srv.step()
    assert srv.layer_log[-1][1].tolist() == [0, 0]
    srv.sched.lane_depths(32)[1] = 4
    srv.step()
    assert srv.layer_log[-1][1].tolist() == [1, 4]
    assert srv.telemetry()["depth_groups"] == 3


def test_albert_path_is_one_group_a_step(monkeypatch):
    """The shared-layer ALBERT classifier keeps its one fused step: one
    ``sharded_classifier_head_step`` a step, counted as one depth group,
    every lane-layer global (full attention), no layer log."""
    from repro_torch.serving import step_math

    cfg = get_smoke_config("albert_edgebert")
    cfg = dataclasses.replace(cfg, dtype="float32").with_edgebert(
        span=dataclasses.replace(cfg.edgebert.span, enabled=False))
    srv = ClassifierServer(build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                           batch_lanes=4, buckets=(16, 32), device="cpu")
    calls = []
    real = step_math.sharded_classifier_head_step
    monkeypatch.setattr(step_math, "sharded_classifier_head_step", lambda *a, **k: calls.append(1) or real(*a, **k))
    for i, n in enumerate((12, 32, 9, 24, 16, 5)):
        srv.submit(Request(uid=i, tokens=np.arange(3, 3 + n, dtype=np.int32)))
    srv.run()
    tel = srv.telemetry()
    assert len(calls) == tel["dense_steps"] == tel["depth_groups"] > 0
    assert tel["lane_layers_global"] == tel["layer_calls"] and tel["lane_layers_local"] == 0
    assert len(srv.layer_log) == 0
