"""The encoder family (ModernBERT-large's early-exit classifier): its
weights, its server (the port's ``ClassifierServer``, every lane at its own
layer, with a shared-clock ``BatchedDVFSArbiter``), its exit threshold, its
warm-up and its check against ``reference/modernbert_ref.py``.  The check's
numbers are the albert family's (``albert.readings``) with the median
layer-2 gap beside them (``readings``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench import encoder_work
from portbench.families import albert
from portbench.families.albert import bucket_of, padded, threshold_for
# the harness calls these on the family: the albert family's serve here too
from portbench.families.albert import done, outcome, request, sample  # noqa: F401
from portbench.gen import draws
from portbench.reference import modernbert_ref, set_tf32

streams_tokens = False


def port_config(cfg: Dict):
    """The port's ``ModelConfig`` as this file states it: the published
    sizes, float32, AdaptivFloat activations as stated, early exit on."""
    from repro_torch.configs.base import get_config

    m, q = cfg["model"], cfg["quant"]
    base = get_config(cfg["port_config"])
    eb = base.edgebert
    eb = dataclasses.replace(
        eb,
        quant=dataclasses.replace(eb.quant, enabled=bool(q), quantize_activations=bool(q),
                                  **({"n_bits": q["n_bits"], "n_exp": q["n_exp"]} if q else {})),
        early_exit=dataclasses.replace(eb.early_exit, enabled=True, num_classes=m["num_classes"]),
    )
    keys = ("n_layers", "d_model", "n_heads", "head_dim", "d_ff", "vocab_size", "max_seq_len", "num_classes",
            "norm_eps", "global_every", "local_window", "rope_theta", "local_rope_theta")
    return dataclasses.replace(base, dtype="float32", remat_policy="none", edgebert=eb, n_kv_heads=m["n_heads"],
                               **{k: m[k] for k in keys})


def ref_model(cfg: Dict) -> Dict:
    return dict(cfg["model"], quant=cfg["quant"])


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The port's parameter tree drawn on ``device`` from ``seed``: normal
    weights scaled by 1 / sqrt(fan-in) (the token embedding by 0.02), unit
    LayerNorm scales (no biases), zero classifier biases; every layer's MLP
    ``w_up`` and ``w_down`` pruned by magnitude to the stated sparsity in
    square tiles.  The port's configuration is looked up first, so a
    program that lacks it stops here."""
    port_config(cfg)
    m = cfg["model"]
    L, d, ff, V, C = m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"], m["num_classes"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) & (2 ** 63 - 1))

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    def norm(*lead):
        return {"scale": torch.ones(lead + (d,), device=dev)}

    p = {"embed": {"tok": normal((V, d), 0.02), "norm": norm()},
         "layers": {"attn_norm": norm(L), "attn": {k: normal((L, d, d), d ** -0.5) for k in ("wq", "wk", "wv", "wo")},
                    "mlp_norm": norm(L),
                    "mlp": {"w_up": normal((L, d, 2 * ff), d ** -0.5), "w_down": normal((L, ff, d), ff ** -0.5)}},
         "offramps": {"norm": norm(L), "dense": normal((L, d, d), d ** -0.5), "head_norm": norm(L),
                      "cls_w": normal((L, d, C), d ** -0.5), "cls_b": torch.zeros((L, C), device=dev)}}
    pr = cfg["prune"]
    for name in ("w_up", "w_down"):
        w = p["layers"]["mlp"][name]
        for i in range(L):
            w[i] = albert.prune_tiles(w[i], pr["sparsity"], pr["tile"])
    return p


def ref_traces(cfg: Dict, params: Dict, tokens: List[np.ndarray], device, chunk: int = 4, ties: bool = False,
               **fault):
    """The reference's off-ramp logits [N, L, C] and entropies [N, L] for
    each document, padded to its own bucket, computed in chunks of one
    bucket; with ``ties`` also each document's candidate first entropies
    under AdaptivFloat rounding ties (``modernbert_ref.first_entropies``).
    ``fault`` goes to ``modernbert_ref.traces`` (``layers``,
    ``global_layers``)."""
    m = ref_model(cfg)
    order = sorted(range(len(tokens)), key=lambda i: bucket_of(cfg, len(tokens[i])))
    lg = np.zeros((len(tokens), m["n_layers"], m["num_classes"]))
    ent = np.zeros((len(tokens), m["n_layers"]))
    cands = [None] * len(tokens)
    i = 0
    with torch.no_grad():
        while i < len(order):
            S = bucket_of(cfg, len(tokens[order[i]]))
            j = i
            while j < len(order) and j - i < chunk and bucket_of(cfg, len(tokens[order[j]])) == S:
                j += 1
            idx = order[i:j]
            toks, lens = padded(cfg, [tokens[k] for k in idx], device)
            l, e = modernbert_ref.traces(params, toks, lens, m, **fault)
            lg[idx] = l.transpose(0, 1).double().cpu().numpy()
            ent[idx] = e.transpose(0, 1).double().cpu().numpy()
            if ties:
                for k, c in zip(idx, modernbert_ref.first_entropies(params, toks, lens, m, cfg["check"]["ties_tol"])):
                    cands[k] = c.double().cpu().numpy()
            i = j
    return (lg, ent, cands) if ties else (lg, ent)


def calibrate(cfg: Dict, params: Dict, seed: int, device, traffic: Dict) -> Dict:
    """The exit threshold and the arbiter's exit predictor from the
    reference's full-depth entropies of seeded calibration documents drawn
    with the traffic's lengths: the threshold at which their mean exit
    layer is the configuration's ``mean_exit_layer``.  A document's exit
    is a rare event a layer (~3% of the layers before the last, 42% of
    documents reach the last), so the threshold's work level is as good as
    the number of documents: the reference runs in TF32 here, ~1.6x as
    fast, since the threshold sets how much work a run asks and is judged
    by nothing (PERF.md)."""
    c = cfg["calibration"]
    r = draws.rng(seed, 9)
    lens = draws.inverse_cdf(traffic["length"], (np.arange(c["documents"]) + 0.5) / c["documents"])
    toks = [r.integers(3, cfg["model"]["vocab_size"], int(n)).astype(np.int32) for n in lens]
    set_tf32(True)
    try:
        _, ent = ref_traces(cfg, params, toks, device)
    finally:
        set_tf32(False)
    thr = threshold_for(ent, c["mean_exit_layer"])
    below = np.concatenate([ent[:, :-1] < thr, np.ones((len(ent), 1), bool)], axis=1)
    return {"threshold": thr, "first_entropy": ent[:, 0], "exits": np.argmax(below, axis=1) + 1}


def build_server(cfg: Dict, params: Dict, cal: Dict, device):
    """The port's ``ClassifierServer``: the stated lanes and buckets, the
    exit threshold, a shared-clock arbiter over ModernBERT's layer (each
    layer priced as the mean of its global and local layers) whose latency
    target is the full-depth latency of a document of the largest bucket
    on the modeled accelerator and whose exit predictor is fitted to the
    calibration.  The server's layer log goes into ``cal`` for the readers
    (``layer_log``)."""
    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.hwmodel.edgebert_accel import modernbert_layer_stats
    from repro_torch.models.model import build_model
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, default_albert_controller, no_early_exit_baseline
    from repro_torch.serving.engine import ClassifierServer

    pc = port_config(cfg)
    pc = pc.with_edgebert(early_exit=dataclasses.replace(pc.edgebert.early_exit,
                                                         entropy_threshold=cal["threshold"]))
    m, s = cfg["model"], cfg["server"]
    S = max(s["buckets"])
    stats = modernbert_layer_stats(seq_len=S, d=m["d_model"], ff=m["d_ff"], heads=m["n_heads"],
                                   n_layers=m["n_layers"], global_every=m["global_every"],
                                   local_span=m["local_window"])
    ctrl = default_albert_controller(no_early_exit_baseline(stats)["latency_s"], seq_len=S, n_layers=pc.n_layers,
                                     predictor=fit_exit_predictor(cal["first_entropy"], cal["exits"], n_bins=8),
                                     stats=stats)
    server = ClassifierServer(build_model(pc), params, batch_lanes=s["lanes"], buckets=tuple(s["buckets"]),
                              arbiter=BatchedDVFSArbiter(ctrl), device=device)
    cal["layer_log"] = server.layer_log
    return server


def warmup(cfg: Dict, server, traffic) -> None:
    """One drain of a lane's worth of documents of seeded tokens in each
    bucket the traffic's lengths reach, at the bucket's longest length the
    traffic gives: their exits differ, so the steps run every group size
    from all lanes down to one, global and local layers, before the
    window."""
    lo, hi = traffic.lengths
    lanes = cfg["server"]["lanes"]
    r = np.random.default_rng(0)
    prev = 0
    uid = -1
    for b in cfg["server"]["buckets"]:
        if b >= lo and prev < hi:
            n = min(b, hi)
            for _ in range(lanes):
                server.submit(request(uid, {"tokens": r.integers(3, cfg["model"]["vocab_size"], n).astype(np.int32)}))
                uid -= 1
        prev = b
    server.run()
    server.poll()


# documents a layer needs for its median gap to enter ``deep_gap_p50_max``
DEEP_MIN_DOCS = 4


def readings(ref_lg, ref_ent, cands, outs: List[Dict], thr: float) -> Dict:
    """``albert.readings``, and:

    * ``ent2_gap_p50``: the median over the documents that ran layer 2 of
      the gap between their entropy after it and the reference's.  At 8192
      positions an AdaptivFloat flip (one grid step of one element where
      the two sides' float32 values straddle a rounding boundary) lands in
      most documents' layer-1 output, and a flip near the CLS row moves the
      layer-2 entropy of a few documents by up to ~1e-3, so the median and
      not the 90th percentile is compared;
    * ``deep_gap_p50_max``: over layers 3 to the last, each run by at least
      ``DEEP_MIN_DOCS`` documents, the largest median gap (the same gap,
      at that layer).  A layer computed wrongly moves every later entropy
      of every document that runs it; the flips compound to gaps of ~5e-3
      by layer 5 in sound runs, and a precision one step lower (TF32) from
      layer 3 on reads as they do (PERF.md)."""
    out = albert.readings(ref_lg, ref_ent, cands, outs, thr)
    g2 = [abs(o["trace"][1] - ref_ent[i, 1]) for i, o in enumerate(outs) if len(o["trace"]) > 1]
    out["ent2_gap_p50"] = float(np.median(g2)) if g2 else 0.0
    deep = [0.0]
    for k in range(2, ref_ent.shape[1]):
        g = [abs(o["trace"][k] - ref_ent[i, k]) for i, o in enumerate(outs) if len(o["trace"]) > k]
        if len(g) >= DEEP_MIN_DOCS:
            deep.append(float(np.median(g)))
    out["deep_gap_p50_max"] = max(deep)
    return out


def check(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    """The sampled documents' outcomes against the float32 reference."""
    set_tf32(False)
    lg, ent, cands = ref_traces(cfg, params, [r.spec["tokens"] for r in recs], device, ties=True)
    return readings(lg, ent, cands, [r.out for r in recs], cal["threshold"])


def control(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    """The reference in TF32 put in the program's place: its own exit
    layers, logits and entropies, judged as the program's are."""
    toks = [r.spec["tokens"] for r in recs]
    set_tf32(True)
    lg32, ent32 = ref_traces(cfg, params, toks, device)
    set_tf32(False)
    lg, ent, cands = ref_traces(cfg, params, toks, device, ties=True)
    return readings(lg, ent, cands, albert.ref_outcomes(lg32, ent32, cal["threshold"]), cal["threshold"])


def faults(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict[str, Dict]:
    """Faults planted in the float32 reference put in the program's place,
    each judged as the program is:

    * ``local_as_global``: the first local layer (layer 1) attends over
      every key;
    * ``global_as_local``: a deep global layer (``deep_global_layer``)
      attends in the local window;
    * ``wrong_layer``: one document in every ``server.lanes`` (one lane's
      worth) of those that run past layer 2 runs layer 2's weights and
      off-ramp at its second step (where layer 1's belong), then goes on
      from layer 2;
    * ``exit_late``: every document that exits early runs one layer more
      and answers there;
    * ``answer_before``: the answer is the logits of the layer before the
      exit."""
    thr, L = cal["threshold"], cfg["model"]["n_layers"]
    toks = [r.spec["tokens"] for r in recs]
    lg, ent, cands = ref_traces(cfg, params, toks, device, ties=True)
    sound = albert.ref_outcomes(lg, ent, thr)
    late = [dict(o, exit=min(o["exit"] + 1, L), result=lg[i, min(o["exit"] + 1, L) - 1],
                 trace=list(ent[i, : min(o["exit"] + 1, L)])) for i, o in enumerate(sound)]
    before = [dict(o, result=lg[i, max(o["exit"] - 2, 0)]) for i, o in enumerate(sound)]
    lg_g, ent_g = ref_traces(cfg, params, toks, device, global_layers=(1,))
    lg_l, ent_l = ref_traces(cfg, params, toks, device, local_layers=(deep_global_layer(cfg),))
    wrong = [0, 2] + list(range(2, L))
    idx = np.flatnonzero([o["exit"] > 2 for o in sound])[:: cfg["server"]["lanes"]]
    lg_w, ent_w = lg.copy(), ent.copy()
    lg_w[idx], ent_w[idx] = ref_traces(cfg, params, [toks[i] for i in idx], device, layers=wrong)
    return {name: readings(lg, ent, cands, outs, thr)
            for name, outs in (("local_as_global", albert.ref_outcomes(lg_g, ent_g, thr)),
                               ("wrong_layer", albert.ref_outcomes(lg_w, ent_w, thr)),
                               ("global_as_local", albert.ref_outcomes(lg_l, ent_l, thr)),
                               ("exit_late", late), ("answer_before", before))}


def deep_global_layer(cfg: Dict) -> int:
    """The global layer at the middle of the depth, where the planted
    ``global_as_local`` fault sits: 0-based layer 15 of 28 (3 of 6 at the
    tests' smoke size)."""
    m = cfg["model"]
    return (m["n_layers"] // 2 + 1) // m["global_every"] * m["global_every"]


def window_flops(ctx) -> float:
    """Model FLOPs of the documents answered in the window: each one's real
    tokens through as many layers as its exit depth, each layer's kind of
    attention, with the off-ramps (``encoder_work.doc_flops``)."""
    w, cfg = ctx["w"], ctx["cfg"]
    return sum(encoder_work.doc_flops(cfg["model"], len(r.spec["tokens"]), r.out["exit"], density(cfg))
               for r in w["recs"] if r.out is not None and r.done_t is not None and w["t0"] <= r.done_t <= w["h_end"])


def vocab(cfg: Dict) -> int:
    return cfg["model"]["vocab_size"]


def density(cfg: Dict) -> float:
    return 1.0 - cfg["prune"]["sparsity"]
