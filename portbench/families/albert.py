"""The EdgeBERT classifier family: its weights, its server (the port's
``ClassifierServer`` with a shared-clock ``BatchedDVFSArbiter``), its exit
threshold, its warm-up and its check against ``reference/albert_ref.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.gen import draws
from portbench.reference import albert_ref, set_tf32

streams_tokens = False


def port_config(cfg: Dict):
    """The port's ``ModelConfig`` as this file states it: the published
    sizes, float32, the EdgeBERT features switched as stated."""
    from repro_torch.configs.base import get_config

    m = cfg["model"]
    base = get_config(cfg["port_config"])
    q = cfg["quant"]
    eb = base.edgebert
    eb = dataclasses.replace(
        eb,
        span=dataclasses.replace(eb.span, enabled=cfg["span"]),
        quant=dataclasses.replace(eb.quant, enabled=bool(q), quantize_activations=bool(q),
                                  **({"n_bits": q["n_bits"], "n_exp": q["n_exp"]} if q else {})),
        early_exit=dataclasses.replace(eb.early_exit, enabled=True, num_classes=m["num_classes"]),
    )
    keys = ("n_layers", "d_model", "n_heads", "head_dim", "d_ff", "vocab_size", "embed_dim", "max_seq_len")
    return dataclasses.replace(base, dtype="float32", remat_policy="none", edgebert=eb,
                               n_kv_heads=m["n_heads"], num_classes=m["num_classes"],
                               **{k: m[k] for k in keys})


def ref_model(cfg: Dict) -> Dict:
    return dict(cfg["model"], quant=cfg["quant"])


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The port's parameter tree drawn on ``device`` from ``seed``: normal
    weights scaled by 1 / sqrt(fan-in) (the embeddings by 0.02), unit
    LayerNorms, zero biases; the encoder MLP's w_up and w_down pruned by
    magnitude to the stated sparsity in square tiles (the tiles of least
    absolute sum are zeroed)."""
    m = cfg["model"]
    d, ff, E, V, C = m["d_model"], m["d_ff"], m["embed_dim"], m["vocab_size"], m["num_classes"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) & (2 ** 63 - 1))

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    def norm():
        return {"scale": torch.ones(d, device=dev), "norm_bias": torch.zeros(d, device=dev)}

    p = {"embed": {"tok": normal((V, E), 0.02), "proj": normal((E, d), E ** -0.5),
                   "pos": normal((m["max_seq_len"], d), 0.02)},
         "layer": {"norm1": norm(), "norm2": norm(),
                   "attn": {k: normal((d, d), d ** -0.5) for k in ("wq", "wk", "wv", "wo")},
                   "mlp": {"w_up": normal((d, ff), d ** -0.5), "w_down": normal((ff, d), ff ** -0.5)}},
         "offramp": {"offramp_pooler_w": normal((d, d), d ** -0.5), "offramp_pooler_b": torch.zeros(d, device=dev),
                     "offramp_cls_w": normal((d, C), d ** -0.5), "offramp_cls_b": torch.zeros(C, device=dev)}}
    pr = cfg["prune"]
    for name in ("w_up", "w_down"):
        p["layer"]["mlp"][name] = prune_tiles(p["layer"]["mlp"][name], pr["sparsity"], pr["tile"])
    return p


def prune_tiles(w: torch.Tensor, sparsity: float, tile: int) -> torch.Tensor:
    """``w`` with the ``sparsity`` share of its tile x tile blocks of least
    absolute sum set to zero."""
    K, N = w.shape
    score = w.abs().reshape(K // tile, tile, N // tile, tile).sum(dim=(1, 3))
    n_zero = int(round(sparsity * score.numel()))
    keep = torch.ones(score.numel(), dtype=torch.bool, device=w.device)
    keep[score.flatten().argsort()[:n_zero]] = False
    keep = keep.reshape(score.shape).repeat_interleave(tile, 0).repeat_interleave(tile, 1)
    return w * keep


def bucket_of(cfg: Dict, n: int) -> int:
    return min(b for b in cfg["server"]["buckets"] if b >= n)


def padded(cfg: Dict, tokens: List[np.ndarray], device):
    """Sentences of one bucket as the server pads them -> (tokens [B, S],
    lengths [B])."""
    S = bucket_of(cfg, max(len(t) for t in tokens))
    out = np.zeros((len(tokens), S), np.int64)
    for i, t in enumerate(tokens):
        out[i, : len(t)] = t
    return (torch.as_tensor(out, device=device),
            torch.as_tensor([len(t) for t in tokens], device=device))


def ref_traces(cfg: Dict, params: Dict, tokens: List[np.ndarray], device, chunk: int = 64, ties: bool = False):
    """The reference's off-ramp logits [N, L, C] and entropies [N, L] for
    each sentence, padded to its own bucket, computed in chunks of one
    bucket; with ``ties`` also each sentence's candidate first entropies
    under AdaptivFloat rounding ties (``albert_ref.first_entropies``)."""
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
            l, e = albert_ref.traces(params, toks, lens, m)
            lg[idx] = l.transpose(0, 1).double().cpu().numpy()
            ent[idx] = e.transpose(0, 1).double().cpu().numpy()
            if ties:
                for k, c in zip(idx, albert_ref.first_entropies(params, toks, lens, m, cfg["check"]["ties_tol"])):
                    cands[k] = c.double().cpu().numpy()
            i = j
    return (lg, ent, cands) if ties else (lg, ent)


def mean_exit(ent: np.ndarray, thr: float) -> float:
    """The mean exit layer of sentences whose off-ramp entropies are
    ``ent`` [N, L] under threshold ``thr``."""
    below = np.concatenate([ent[:, :-1] < thr, np.ones((len(ent), 1), bool)], axis=1)
    return float((np.argmax(below, axis=1) + 1).mean())


def threshold_for(ent: np.ndarray, target: float) -> float:
    """The smallest threshold, midway between two observed entropies, at
    which the mean exit layer of ``ent`` [N, L] falls to ``target`` or
    below: the work a sentence needs on average is fixed by the
    configuration, whatever weights the seed draws."""
    vals = np.unique(ent[:, :-1])
    cands = np.concatenate([[vals[0] - 1e-3], (vals[:-1] + vals[1:]) / 2, [vals[-1] + 1e-3]])
    lo, hi = 0, len(cands) - 1            # mean_exit falls as the threshold rises
    while lo < hi:
        mid = (lo + hi) // 2
        if mean_exit(ent, cands[mid]) <= target:
            hi = mid
        else:
            lo = mid + 1
    return float(cands[lo])


def calibrate(cfg: Dict, params: Dict, seed: int, device, traffic: Dict) -> Dict:
    """The exit threshold and the arbiter's exit predictor from the
    reference's full-depth entropies of seeded calibration sentences drawn
    with the traffic's lengths: the threshold at which their mean exit
    layer is the configuration's ``mean_exit_layer``."""
    c = cfg["calibration"]
    r = draws.rng(seed, 9)
    lens = draws.inverse_cdf(traffic["length"], (np.arange(c["sentences"]) + 0.5) / c["sentences"])
    toks = [r.integers(3, cfg["model"]["vocab_size"], int(n)).astype(np.int32) for n in lens]
    _, ent = ref_traces(cfg, params, toks, device)
    thr = threshold_for(ent, c["mean_exit_layer"])
    below = np.concatenate([ent[:, :-1] < thr, np.ones((len(ent), 1), bool)], axis=1)
    return {"threshold": thr, "first_entropy": ent[:, 0], "exits": np.argmax(below, axis=1) + 1}


def build_server(cfg: Dict, params: Dict, cal: Dict, device):
    """The port's ``ClassifierServer``: the stated lanes and buckets, the
    exit threshold, a shared-clock arbiter whose latency target is the
    full-depth latency of a bucket-128 sentence on the modeled accelerator
    and whose exit predictor is fitted to the calibration."""
    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.models.model import build_model
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, default_albert_controller, no_early_exit_baseline
    from repro_torch.serving.engine import ClassifierServer

    pc = port_config(cfg)
    pc = pc.with_edgebert(early_exit=dataclasses.replace(pc.edgebert.early_exit,
                                                         entropy_threshold=cal["threshold"]))
    s = cfg["server"]
    S = max(s["buckets"])
    target = no_early_exit_baseline(albert_layer_stats(seq_len=S))["latency_s"]
    ctrl = default_albert_controller(target, seq_len=S, n_layers=pc.n_layers,
                                     predictor=fit_exit_predictor(cal["first_entropy"], cal["exits"], n_bins=8))
    return ClassifierServer(build_model(pc), params, batch_lanes=s["lanes"], buckets=tuple(s["buckets"]),
                            arbiter=BatchedDVFSArbiter(ctrl), device=device)


def request(uid: int, spec: Dict):
    from repro_torch.serving.engine import Request

    return Request(uid=uid, tokens=spec["tokens"])


def warmup(cfg: Dict, server, traffic) -> None:
    """One drain of two lanes' worth of sentences in each bucket the
    traffic's lengths reach, at the bucket's longest length the traffic
    gives: every shape of the window built and run once."""
    lo, hi = traffic.lengths
    lanes = cfg["server"]["lanes"]
    prev = 0
    uid = -1
    for b in cfg["server"]["buckets"]:
        if b >= lo and prev < hi:
            n = min(b, hi)
            for _ in range(2 * lanes):
                server.submit(request(uid, {"tokens": np.full(n, 7, np.int32)}))
                uid -= 1
        prev = b
    server.run()
    server.poll()


def outcome(req) -> Dict:
    return {"result": np.asarray(req.result, np.float64), "exit": int(req.exit_layer),
            "trace": list(req.entropy_trace)}


def done(req) -> bool:
    return req.exit_layer is not None


def sample(recs: List, seed: int, k: int) -> List:
    """A seeded sample of the sentences due in the window."""
    r = draws.rng(seed, 10)
    idx = r.choice(len(recs), size=min(k, len(recs)), replace=False)
    return [recs[i] for i in sorted(idx)]


def rule_breaks(outs: List[Dict], thr: float, n_layers: int) -> int:
    """Sentences whose exit layer is not the one the threshold rule gives on
    their own entropy trace: the trace is as long as the exit, every entry
    before the last is at or above the threshold, and the last is below it
    unless the sentence ran every layer (the threshold in float32, as the
    step compares it)."""
    t32 = np.float32(thr)
    bad = 0
    for o in outs:
        tr = np.asarray(o["trace"], np.float32)
        ok = len(tr) == o["exit"] and bool(np.all(tr[:-1] >= t32))
        ok = ok and (bool(tr[-1] < t32) or o["exit"] == n_layers) if len(tr) else False
        bad += not ok
    return bad


def readings(ref_lg, ref_ent, cands, outs: List[Dict], thr: float) -> Dict:
    """The numbers compared, for sentences judged against the reference's
    logits ``ref_lg`` [N, L, C], entropies ``ref_ent`` [N, L] and candidate
    first entropies ``cands``:

    * ``ent1_gap``: the widest gap between a sentence's off-ramp entropy
      after layer 1 and the nearest of the reference's candidates (the
      entropies the layer's float32 output, moved by ``ties_tol``, can give
      through AdaptivFloat rounding);
    * ``ent2_gap_p90``: the 90th percentile over the sentences that ran
      layer 2 of the gap between their entropy after it and the
      reference's;
    * ``exit_logit_gap_p50`` and ``exit_logit_gap``: the median and the
      widest, over the sentences, of the widest gap between a sentence's
      logits and the reference's at its exit layer;
    * ``exit_mismatch``: the share of the sentences that exit at another
      layer than the reference's;
    * ``exit_rule``: the sentences whose exit breaks the threshold rule on
      their own entropies (``rule_breaks``).

    Beside them, not compared: ``ent1_gap_plain`` (the gap to the
    reference's own rounding) and ``ent2_gap`` (the widest after layer 2):
    AdaptivFloat flips, one rounding step of one element, carry through
    the later layers alike in the program and in its control, so single
    sentences stray (PERF.md)."""
    g1 = [float(np.abs(cands[i] - o["trace"][0]).min()) for i, o in enumerate(outs)]
    plain = [abs(o["trace"][0] - ref_ent[i, 0]) for i, o in enumerate(outs)]
    g2 = [abs(o["trace"][1] - ref_ent[i, 1]) for i, o in enumerate(outs) if len(o["trace"]) > 1]
    lgs = [float(np.abs(o["result"] - ref_lg[i, o["exit"] - 1]).max()) for i, o in enumerate(outs)]
    ref_exit = albert_ref.exit_layers(torch.as_tensor(ref_ent.T), thr).numpy()
    return {"ent1_gap": max(g1), "ent2_gap_p90": float(np.percentile(g2, 90)) if g2 else 0.0,
            "exit_logit_gap_p50": float(np.median(lgs)),
            "exit_mismatch": float(np.mean([o["exit"] != ref_exit[i] for i, o in enumerate(outs)])),
            "exit_rule": rule_breaks(outs, thr, ref_ent.shape[1]),
            "ent1_gap_plain": float(max(plain)), "ent2_gap": float(max(g2)) if g2 else 0.0,
            "exit_logit_gap": max(lgs),
            "tied_sentences": int(sum(len(np.unique(c)) > 1 for c in cands))}


def check(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    """The sampled sentences' outcomes against the float32 reference."""
    set_tf32(False)
    lg, ent, cands = ref_traces(cfg, params, [r.spec["tokens"] for r in recs], device, ties=True)
    return readings(lg, ent, cands, [r.out for r in recs], cal["threshold"])


def ref_outcomes(lg: np.ndarray, ent: np.ndarray, thr: float) -> List[Dict]:
    """Outcomes as the server reports them, from reference logits [N, L, C]
    and entropies [N, L] under threshold ``thr``."""
    ex = albert_ref.exit_layers(torch.as_tensor(ent.T), thr).numpy()
    return [{"result": lg[i, ex[i] - 1], "exit": int(ex[i]), "trace": list(ent[i, : ex[i]])}
            for i in range(len(ent))]


def control(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    """The reference in TF32 put in the program's place: its own exit
    layers, logits and entropies, judged as the program's are."""
    toks = [r.spec["tokens"] for r in recs]
    set_tf32(True)
    lg32, ent32 = ref_traces(cfg, params, toks, device)
    set_tf32(False)
    lg, ent, cands = ref_traces(cfg, params, toks, device, ties=True)
    return readings(lg, ent, cands, ref_outcomes(lg32, ent32, cal["threshold"]), cal["threshold"])


def faults(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict[str, Dict]:
    """Faults planted in the float32 reference put in the program's place,
    each judged as the program is:

    * ``exit_late``: every sentence that exits early runs one layer more
      and answers there;
    * ``answer_before``: the answer is the logits of the layer before the
      exit;
    * ``lane_state_l2``: one sentence in every ``server.lanes`` (one lane's
      worth) keeps its state through layer 2 once, so from layer 3 on it
      runs one layer behind."""
    thr, L = cal["threshold"], cfg["model"]["n_layers"]
    lg, ent, cands = ref_traces(cfg, params, [r.spec["tokens"] for r in recs], device, ties=True)
    sound = ref_outcomes(lg, ent, thr)
    late = [dict(o, exit=min(o["exit"] + 1, L), result=lg[i, min(o["exit"] + 1, L) - 1],
                 trace=list(ent[i, : min(o["exit"] + 1, L)])) for i, o in enumerate(sound)]
    before = [dict(o, result=lg[i, max(o["exit"] - 2, 0)]) for i, o in enumerate(sound)]
    keep = np.r_[0, 1, 1, np.arange(2, L - 1)]            # layer k's output is layer keep[k]'s
    stuck = np.zeros(len(sound), bool)
    stuck[:: cfg["server"]["lanes"]] = True
    ent_s = np.where(stuck[:, None], ent[:, keep], ent)
    lg_s = np.where(stuck[:, None, None], lg[:, keep], lg)
    return {name: readings(lg, ent, cands, outs, thr)
            for name, outs in (("exit_late", late), ("answer_before", before),
                               ("lane_state_l2", ref_outcomes(lg_s, ent_s, thr)))}


def sentence_flops(cfg: Dict, rec) -> float:
    from portbench import work

    pr = cfg["prune"]
    return work.albert_sentence_flops(cfg["model"], len(rec.spec["tokens"]), rec.out["exit"], 1.0 - pr["sparsity"])


def window_flops(ctx) -> float:
    """Model FLOPs of the sentences answered in the window: each one's real
    tokens through as many layers as its exit depth, with the off-ramps."""
    w = ctx["w"]
    return sum(sentence_flops(ctx["cfg"], r) for r in w["recs"]
               if r.out is not None and r.done_t is not None and w["t0"] <= r.done_t <= w["h_end"])


def vocab(cfg: Dict) -> int:
    return cfg["model"]["vocab_size"]


def density(cfg: Dict) -> float:
    return 1.0 - cfg["prune"]["sparsity"]
