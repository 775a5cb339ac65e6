#!/usr/bin/env python3
"""Drive the PyTorch port of EdgeBERT on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:
  1. device   — the card, as nvidia-smi reports its name and power limit;
  2. build    — compile every CUDA kernel of the deployed path (one nvcc per
                source, all at once) and report nvcc's register/spill lines;
  3. kernel   — each kernel against its plain PyTorch version at the main
                path's shapes, with a stated tolerance, and its time beside
                the plain version's, one PyTorch library call's and its bound;
  4. reference — the deployed model on the card against the same model on
                the CPU (plain versions), at smoke size and at full width;
  5. main     — full-width albert_edgebert: init_params -> deploy_albert
                (MLC2 eNVM) -> classify -> classify_with_dvfs on 16 seeded
                sentences of 128 tokens, with every kernel's launch count.
Then the `{"kernels": [...]}` summary, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Any failure raises: the script exits
non-zero and prints no final line.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero at once.  A copy of every
line also goes to build/chip_smoke.json.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 rate
# and the fp32 rate outside the tensor cores, where these kernels compute.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

RECORD: list = []


def emit(obj) -> None:
    RECORD.append(obj)
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, flops: float) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time per call from CUDA events over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dep, cfg, dev) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.adaptivfloat import af_decode
    from repro_torch.kernels import ref
    from repro_torch.kernels.adaptivfloat_k import af_matmul
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.softmax_entropy import softmax_entropy
    from repro_torch.kernels.span_attention import span_attention

    g = torch.Generator(device=dev).manual_seed(1)
    B, S, d, H, hd = 16, 128, cfg.d_model, cfg.n_heads, cfg.head_dim
    M = B * S
    rows = []

    def row(name, source, replaces, shape, err, tol, ok, ms, plain_ms, n_bytes, flops, library_ms,
            **detail):
        b_ms, b_by = bound_ms(n_bytes, flops)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "shape": shape, "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms}
        emit({"phase": "kernel", **r, **detail})
        if not ok:
            raise AssertionError(f"{name}: kernel and plain version disagree beyond {tol} (max abs error {err})")
        rows.append(r)

    # layernorm [2048, 768]
    x = torch.randn(M, d, generator=g, device=dev) * 3.0
    gam = dep.layer["norm1_scale"] + 0.1 * torch.randn(d, generator=g, device=dev)
    bet = 0.1 * torch.randn(d, generator=g, device=dev)
    err = (layernorm(x, gam, bet) - ref.layernorm(x, gam, bet)).abs().max().item()
    row("layernorm", "src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/layernorm.py:17",
        f"[{M}, {d}] fp32", err, "atol 1e-5", err <= 1e-5,
        time_ms(lambda: layernorm(x, gam, bet)), time_ms(lambda: ref.layernorm(x, gam, bet)),
        (2 * M * d + 2 * d) * 4, 8 * M * d,
        time_ms(lambda: F.layer_norm(x, (d,), gam, bet, eps=1e-6)))

    # softmax_entropy [16, 3]
    C = cfg.edgebert.early_exit.num_classes
    lg = torch.randn(B, C, generator=g, device=dev) * 2.0
    p, h = softmax_entropy(lg)
    rp, rh = ref.softmax_entropy(lg)
    err = max((p - rp).abs().max().item(), (h - rh).abs().max().item())
    row("softmax_entropy", "src/repro_torch/csrc/softmax_entropy.cu",
        "src/repro/kernels/softmax_entropy.py:17", f"[{B}, {C}] fp32", err, "atol 1e-6", err <= 1e-6,
        time_ms(lambda: softmax_entropy(lg)), time_ms(lambda: ref.softmax_entropy(lg)),
        (2 * B * C + B) * 4, 10 * B * C, None)

    # af_matmul: one encoder layer's six matmuls at M = 2048, on the deployed codes
    ms = plain = lib = n_bytes = flops = err = 0.0
    ok = True
    shapes = []
    per_shape = {}
    xs = torch.randn(M, max(d, cfg.d_ff), generator=g, device=dev)
    for name in ("wq", "wk", "wv", "wo", "w_up", "w_down"):
        w = dep.layer[name]
        K, N = w.codes.shape
        xk = xs[:, :K].contiguous()
        want = ref.af_matmul(xk, w.codes, w.e_min)
        got = af_matmul(xk, w.codes, w.e_min)
        err = max(err, (got - want).abs().max().item())
        ok = ok and torch.allclose(got, want, rtol=1e-5, atol=1e-5)
        w_dec = af_decode(w.codes, w.e_min)
        t = (time_ms(lambda: af_matmul(xk, w.codes, w.e_min), iters=20),
             time_ms(lambda: ref.af_matmul(xk, w.codes, w.e_min), iters=20),
             time_ms(lambda: torch.matmul(xk, w_dec), iters=20))
        nb, nf = M * K * 4 + K * N + M * N * 4, 2.0 * M * K * N
        per_shape[name] = {"K": K, "N": N, "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                           "bound_ms": bound_ms(nb, nf)[0]}
        ms, plain, lib = ms + t[0], plain + t[1], lib + t[2]
        n_bytes, flops = n_bytes + nb, flops + nf
        shapes.append(f"{K}x{N}")
    row("af_matmul", "src/repro_torch/csrc/af_matmul.cu", "src/repro/kernels/adaptivfloat_k.py:99",
        f"M={M}, one layer: {' + '.join(shapes)} (times and bound summed)", err,
        "rtol 1e-5 + atol 1e-5", ok,
        ms, plain, n_bytes, flops, lib, per_shape=per_shape)

    # span_attention: BH = 16 sentences x 12 live heads, S = 128, dh = 64
    spans_np = np.tile(np.asarray(dep.spans, np.int32), B)
    window = int(spans_np.max())
    BH = spans_np.size
    q, k, v = (torch.randn(BH, S, hd, generator=g, device=dev) for _ in range(3))
    spans = torch.as_tensor(spans_np, device=dev)
    want = span_attention(q.cpu(), k.cpu(), v.cpu(), spans.cpu(), window, causal=False)
    got = span_attention(q, k, v, spans, window, causal=False)
    err = (got.cpu() - want).abs().max().item()
    dist = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :])
    pairs = sum(int((dist < s).sum()) for s in spans_np)
    mask = torch.as_tensor(dist[None] < spans_np[:, None, None], device=dev)
    row("span_attention", "src/repro_torch/csrc/span_attention.cu",
        "src/repro/kernels/span_attention.py:32",
        f"BH={BH}, S={S}, dh={hd}, window={window}, bidirectional", err, "atol 2e-5", err <= 2e-5,
        time_ms(lambda: span_attention(q, k, v, spans, window, causal=False)),
        time_ms(lambda: ref.span_attention(q[None], k[None], v[None], spans, causal=False)),
        4 * BH * S * hd * 4 + BH * 4, 4.0 * hd * pairs,
        time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)))
    return rows


# ---------------------------------------------------------------------------
# phases 4-5: the deployed model
# ---------------------------------------------------------------------------


def pick_threshold(traces):
    """From a full-depth profiling pass: the median over sentences of each
    sentence's lowest off-ramp entropy before the last layer, nudged into the
    gap above it, so about half the sentences exit early."""
    import numpy as np

    t = np.asarray(traces, np.float64)
    lows = np.sort(t[:, :-1].min(axis=1))
    i = len(lows) // 2
    hi = lows[i + 1] if i + 1 < len(lows) else lows[i] + 1e-3
    return float((lows[i] + hi) / 2)


def check_reference(dep_full, params_full, cfg_full, dev) -> None:
    """The deployed model on the card against the same model on the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import init_params
    from repro_torch.serving.deploy import deploy_albert

    smoke = get_smoke_config("albert_edgebert")
    smoke_params = init_params(smoke, torch.Generator().manual_seed(3), device="cpu")
    cases = [
        ("smoke", smoke, smoke_params, deploy_albert(smoke_params, smoke, device=dev), 4, 32, 1e-4),
        # 12 layers at d = 768 grow the float32 sum-order drift: 1e-3
        ("full", cfg_full, params_full, dep_full, 2, 128, 1e-3),
    ]
    for name, cfg, params, on_card, B, S, tol in cases:
        tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))
        on_cpu = deploy_albert(params, cfg, device="cpu")
        on_card.threshold = on_cpu.threshold = 0.0
        lg, eg = on_card.classify(tokens)
        lc, ec = on_cpu.classify(tokens)
        err = float(np.abs(lg - lc).max())
        trace_err = float(np.abs(np.asarray(on_card.last_entropy_traces)
                                 - np.asarray(on_cpu.last_entropy_traces)).max())
        emit({"phase": "reference", "config": name, "sentences": B, "seq_len": S,
              "logits_max_abs_err": err, "trace_max_abs_err": trace_err, "tolerance": tol})
        if not (np.array_equal(eg, ec) and err <= tol and trace_err <= tol):
            raise AssertionError(f"card and CPU disagree on the {name} config")


KERNEL_SYMBOLS = {
    "af_matmul_kernel": "af_matmul",
    "span_attention_kernel": "span_attention",
    "layernorm_kernel": "layernorm",
    "softmax_entropy_kernel": "softmax_entropy",
    "Memcpy": "memcpy",
}


def profile_batch(dep, tokens) -> dict:
    """Device time by kernel over one warm batch, from torch.profiler's
    CUDA activity (the port's four kernels by name, the rest of PyTorch's
    kernels as "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dep.classify(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dep.classify(tokens)
        torch.cuda.synchronize()
    groups: dict = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((v for k, v in KERNEL_SYMBOLS.items() if k in evt.key), "other")
        g = groups.setdefault(name, {"ms": 0.0, "calls": 0})
        g["ms"] += evt.self_device_time_total / 1e3
        g["calls"] += evt.count
    return groups


def run_main_path(dep, cfg, dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.serving.dvfs import default_albert_controller, no_early_exit_baseline

    B, S = 16, 128
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    # profiling pass at threshold 0 (every sentence runs all layers)
    dep.threshold = 0.0
    dep.classify(tokens)
    profile = np.asarray(dep.last_entropy_traces)
    thr = pick_threshold(profile)
    below = np.concatenate([profile[:, :-1] < thr, np.ones((B, 1), bool)], axis=1)
    profile_exits = np.argmax(below, axis=1) + 1
    dep.threshold = thr

    stats = albert_layer_stats(seq_len=S)
    target = no_early_exit_baseline(stats)["latency_s"]
    controller = default_albert_controller(
        target, seq_len=S, n_layers=cfg.n_layers,
        predictor=fit_exit_predictor(profile[:, 0], profile_exits, n_bins=8),
    )

    # the main path, counted: one early-exit batch with its DVFS schedule
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, exits, reports = dep.classify_with_dvfs(tokens, controller)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()

    if not np.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    if not ((exits >= 1) & (exits <= cfg.n_layers)).all():
        raise AssertionError(f"exit layers out of range: {exits}")
    if not np.array_equal(exits, profile_exits):
        raise AssertionError(f"exits {exits} differ from the profile's {profile_exits}")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # warm wall time per batch (host clock around synchronised runs)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dep.classify(tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dep.threshold = 0.0
    full = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dep.classify(tokens)
        torch.cuda.synchronize()
        full.append((time.perf_counter() - t0) * 1e3)
    dep.threshold = thr
    by_kernel = profile_batch(dep, tokens)
    busy = sum(g["ms"] for g in by_kernel.values())
    warm = float(np.median(walls))

    base = controller.no_early_exit_baseline()
    result = {
        "phase": "main", "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "sentences": B, "seq_len": S, "envm_cell": "MLC2", "spans": [int(s) for s in dep.spans],
        "threshold": thr, "exit_layers": [int(e) for e in exits],
        "mean_exit": float(np.mean(exits)), "first_batch_ms": first_ms,
        "warm_batch_ms": walls, "warm_batch_ms_median": warm,
        "full_depth_batch_ms": full,
        # device busy time of one warm batch (profiled) against its unprofiled
        # wall time; None where the trace held no device activity
        "device_busy_ms": busy, "device_idle_share": (1.0 - busy / warm) if busy > 0 else None,
        "device_ms_by_kernel": by_kernel,
        "launches": launches,
        "modeled_energy_j": float(sum(r.energy_j for r in reports)),
        "modeled_energy_no_exit_j": float(base["energy_j"] * B),
        "modeled_latency_s": [float(r.latency_s) for r in reports],
        "deadline_met": int(sum(r.deadline_met for r in reports)),
        "target_latency_s": target,
        "ops": sorted({f"{r.op.vdd:.3f}V/{r.op.freq_hz / 1e6:.0f}MHz" for r in reports}),
    }
    emit(result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository (src/repro_torch missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.models.model import init_params
    from repro_torch.serving.deploy import deploy_albert

    smi = nvidia_smi_line()
    dev = resolve_device("cuda")
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    seconds = build.build()
    ptxas = {
        name: [ln.strip() for ln in build.log_path(name).read_text().splitlines()
               if "registers" in ln or "spill" in ln][:8]
        for name in build.KERNELS
    }
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})

    cfg = get_config("albert_edgebert")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dep = deploy_albert(params, cfg, envm_cell="MLC2", seed=0, device=dev)
    emit({"phase": "deploy", "config": cfg.name, "seconds": time.perf_counter() - t0,
          "spans": [int(s) for s in dep.spans]})

    rows = check_kernels(dep, cfg, dev)
    check_reference(dep, params, cfg, dev)
    main_path = run_main_path(dep, cfg, dev)
    for r in rows:
        r["launches"] = main_path["launches"][r["name"]]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = {"kernels": [{k: r[k] for k in keys} for r in rows]}
    RECORD.append(kernels)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(RECORD, indent=1))
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
