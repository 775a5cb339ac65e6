"""The dense decoder family: its weights, its server (the port's
``DecoderServer`` with per-token exit), its exit threshold, its warm-up and
its check against ``reference/dense_ref.py``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.gen import draws
from portbench.reference import dense_ref, set_tf32

streams_tokens = True


def port_config(cfg: Dict):
    from repro_torch.configs.base import get_config

    m = cfg["model"]
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab_size", "rope_theta")
    return dataclasses.replace(get_config(cfg["port_config"]), dtype="float32", remat_policy="none",
                               **{k: m[k] for k in keys})


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The port's parameter tree drawn on ``device`` from ``seed``, one draw
    per stacked leaf: normal weights scaled by 1 / sqrt(fan-in), the token
    embedding and LM head by 0.02, unit RMSNorm scales."""
    m = cfg["model"]
    L, d, ff, V = m["n_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    H, KV, dh = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(int(seed) & (2 ** 63 - 1))

    def normal(shape, scale):
        return torch.randn(shape, generator=g, device=dev).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    return {
        "embed": {"tok": normal((V, d), 0.02)},
        "layers": {
            "norm1": {"scale": ones(L, d)}, "norm2": {"scale": ones(L, d)},
            "attn": {"wq": normal((L, d, H * dh), d ** -0.5), "wk": normal((L, d, KV * dh), d ** -0.5),
                     "wv": normal((L, d, KV * dh), d ** -0.5), "wo": normal((L, H * dh, d), (H * dh) ** -0.5)},
            "mlp": {"w_gate": normal((L, d, ff), d ** -0.5), "w_up": normal((L, d, ff), d ** -0.5),
                    "w_down": normal((L, ff, d), ff ** -0.5)},
        },
        "final_norm": {"scale": ones(d)},
        "lm_head": normal((d, V), 0.02),
    }


def pick_threshold(traces) -> float:
    """The median over tokens of each token's lowest off-ramp entropy
    before the last layer, nudged into the gap above it: about half the
    calibration tokens exit early."""
    t = np.asarray(traces, np.float64)
    lows = np.sort(t[:, :-1].min(axis=1))
    i = len(lows) // 2
    hi = lows[i + 1] if i + 1 < len(lows) else lows[i] + 1e-3
    return float((lows[i] + hi) / 2)


def calibrate(cfg: Dict, params: Dict, seed: int, device, traffic: Dict) -> Dict:
    """The exit threshold from the reference's full-depth off-ramp
    entropies over seeded calibration sequences."""
    c = cfg["calibration"]
    r = draws.rng(seed, 9)
    L = cfg["model"]["n_layers"]
    traces = []
    with torch.no_grad():
        for _ in range(c["sequences"]):
            seq = torch.as_tensor(r.integers(3, cfg["model"]["vocab_size"], c["length"]), device=device)
            ents = []
            dense_ref.forward(params, cfg["model"], seq, torch.full_like(seq, L), 0,
                              lambda l, lg, e: ents.append(e.double().cpu().numpy()))
            traces.append(np.stack(ents, axis=1))                       # [T, L]
    return {"threshold": pick_threshold(np.concatenate(traces))}


def build_server(cfg: Dict, params: Dict, cal: Dict, device):
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import DecoderServer

    s = cfg["server"]
    return DecoderServer(build_model(port_config(cfg)), params, batch_lanes=s["lanes"], max_seq=s["max_seq"],
                         eos_id=s["eos_id"], spec_window=s["spec_window"], exit_threshold=cal["threshold"],
                         device=device)


def request(uid: int, spec: Dict):
    from repro_torch.serving.engine import Request

    return Request(uid=uid, tokens=spec["tokens"], max_new_tokens=spec["max_new_tokens"])


def warmup(cfg: Dict, server, traffic) -> None:
    """One drain of a lane's worth of requests: the prefill's one-token step
    and the fused early-exit step, the only shapes the window runs."""
    for uid in range(cfg["server"]["lanes"]):
        server.submit(request(-1 - uid, {"tokens": np.full(traffic.lengths[0], 7, np.int32),
                                              "max_new_tokens": 4}))
    server.run()
    server.poll()


def outcome(req) -> Dict:
    return {"generated": list(req.generated), "exits": list(req.token_exit_layers),
            "ent1": list(req.entropy_trace)}


def done(req) -> bool:
    return req.finish_time > 0


def sample(recs: List, seed: int, k: int) -> List:
    """A seeded sample of the requests finished in the window, the longest
    among them."""
    if not recs:
        return []
    longest = max(range(len(recs)), key=lambda i: len(recs[i].out["generated"]))
    rest = [i for i in range(len(recs)) if i != longest]
    r = draws.rng(seed, 10)
    pick = r.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [recs[i] for i in sorted([longest] + [rest[j] for j in pick])]


def _sequence(rec, device):
    prompt = np.asarray(rec.spec["tokens"], np.int64)
    gen = rec.out["generated"]
    seq = torch.as_tensor(np.concatenate([prompt, np.asarray(gen[:-1], np.int64)]), device=device)
    return seq, len(prompt) - 1


def _frozen_after(cfg: Dict, seq, fed_from: int, exits) -> torch.Tensor:
    """Each position's exit layer: full depth for the prompt, the program's
    exit layer for each position a fused step fed (the state the program's
    later tokens read, judged separately)."""
    fa = torch.full_like(seq, cfg["model"]["n_layers"])
    fa[fed_from:] = torch.as_tensor(exits, device=seq.device)
    return fa


def readings(cfg: Dict, params: Dict, recs: List, choices: List[Dict], device) -> Dict:
    """Each served token judged against the float32 reference at the same
    positions: ``tok_gap``, the widest gap by which a served token's logit
    lies below the reference's best at the token's exit layer, and
    ``ent_gap``, the widest gap in entropy (nats) between the program's
    first off-ramp entropy and the reference's, or by which the
    reference's entropy at a layer lies on the wrong side of the threshold
    for the program's exit there.  ``choices[i]``: the tokens, exit layers
    and first entropies judged for request i (the program's, or the
    control's)."""
    thr, L = cfg["threshold"], cfg["model"]["n_layers"]
    set_tf32(False)
    tok_gap = ent_gap = 0.0
    n_tokens = 0
    with torch.no_grad():
        for rec, ch in zip(recs, choices):
            seq, fed_from = _sequence(rec, device)
            exits = torch.as_tensor(ch["exits"], device=device)
            toks = torch.as_tensor(ch["generated"], device=device)
            acc = {"gap": torch.zeros(len(ch["exits"]), device=device), "viol": torch.zeros_like(exits, dtype=torch.float32)}

            def on_layer(layer, lg, ent):
                at = exits == layer
                if at.any():
                    best = lg[at].amax(dim=-1)
                    acc["gap"][at] = best - lg[at].gather(1, toks[at][:, None])[:, 0]
                    if layer < L:                   # the last layer is an exit whatever its entropy
                        acc["viol"][at] = torch.maximum(acc["viol"][at], (ent[at] - thr).clamp_min(0))
                before = exits > layer
                acc["viol"][before] = torch.maximum(acc["viol"][before], (thr - ent[before]).clamp_min(0))
                if layer == 1:
                    acc["ent1"] = (ent - torch.as_tensor(ch["ent1"], device=device)).abs()

            dense_ref.forward(params, cfg["model"], seq, _frozen_after(cfg, seq, fed_from, rec.out["exits"]),
                              fed_from, on_layer)
            tok_gap = max(tok_gap, float(acc["gap"].max()))
            ent_gap = max(ent_gap, float(acc["viol"].max()), float(acc["ent1"].max()))
            n_tokens += len(ch["exits"])
    return {"tok_gap": tok_gap, "ent_gap": ent_gap, "tokens_checked": n_tokens}


def check(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    return readings(dict(cfg, threshold=cal["threshold"]), params, recs,
                    [{"generated": r.out["generated"], "exits": r.out["exits"], "ent1": r.out["ent1"]} for r in recs],
                    device)


def control(cfg: Dict, params: Dict, cal: Dict, recs: List, device) -> Dict:
    """The reference in TF32 put in the program's place: at each position of
    the same prompts and served tokens (the program's state), its own exit
    layer, the token it puts first there and its first entropy, judged as
    the program's are."""
    thr = cal["threshold"]
    L = cfg["model"]["n_layers"]
    choices = []
    set_tf32(True)
    with torch.no_grad():
        for rec in recs:
            seq, fed_from = _sequence(rec, device)
            G = len(rec.out["generated"])
            st = {"exit": torch.full((G,), L, device=device), "tok": torch.zeros(G, dtype=torch.long, device=device),
                  "done": torch.zeros(G, dtype=torch.bool, device=device)}

            def on_layer(layer, lg, ent):
                now = ~st["done"] & ((ent < thr) | (layer == L))
                st["exit"][now] = layer
                st["tok"][now] = lg[now].argmax(dim=-1)
                st["done"] |= now
                if layer == 1:
                    st["ent1"] = ent.double().cpu().numpy()

            dense_ref.forward(params, cfg["model"], seq, _frozen_after(cfg, seq, fed_from, rec.out["exits"]),
                              fed_from, on_layer)
            choices.append({"generated": st["tok"].cpu().tolist(), "exits": st["exit"].int().cpu().tolist(),
                            "ent1": list(st["ent1"])})
    set_tf32(False)
    return readings(dict(cfg, threshold=thr), params, recs, choices, device)


def window_flops(ctx) -> float:
    """Model FLOPs of the window's tokens: each generated token one pass
    through every layer at its context, with the LM head after each layer
    up to its exit; each prompt whose first token came in the window, its
    one-token prefill (every layer, no LM head)."""
    from portbench import work

    w, m = ctx["w"], ctx["cfg"]["model"]
    tot = 0.0
    for r in w["recs"]:
        if r.req is None:
            continue
        P = len(r.spec["tokens"])
        exits = list(r.req.token_exit_layers)
        for j, t in enumerate(r.tok_t):
            if w["t0"] <= t <= w["h_end"]:
                tot += work.dense_token_flops(m, P + j, exits[j])
        if r.tok_t and w["t0"] <= r.tok_t[0] <= w["h_end"]:
            tot += sum(work.dense_token_flops(m, i + 1, 0) for i in range(P - 1))
    return tot


def vocab(cfg: Dict) -> int:
    return cfg["model"]["vocab_size"]
