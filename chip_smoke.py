#!/usr/bin/env python3
"""Drive the PyTorch port of EdgeBERT on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:
  1. device   — the card, as nvidia-smi reports its name and power limit;
  2. build    — compile all six CUDA kernels (one nvcc per source, all at
                once) and report each one's registers, spills and shared
                memory;
  3. kernel   — each kernel against its plain PyTorch version at its paths'
                shapes, with a stated tolerance, and its time beside the
                plain version's, one PyTorch library call's and its bound:
                back to back (`ms`) and queued behind a spin (`device_ms`,
                `library_device_ms`: the card's time alone), with the
                host's cost per call (`enqueue_us`) for layernorm and span
                attention; for the three tensor-core kernels the bound is at
                the bf16 tensor-core rate, beside the same work's time at
                the fp32 rate (span attention is called as the paths call
                it, on [B, S, H, dh] views with per-head spans or per-lane
                kv_lens); then every kernel launched twice on the same
                inputs (span attention also with kv_lens and through
                strided [B, S, H, dh] views; the off-ramp head on both
                weight forms; the grouped quantize at every bucket) must
                give the same bits.  softmax_entropy is timed as the
                off-ramp head and af_quantize as the grouped launch
                (quantize_groups), each beside the chain of launches it
                replaces (`replaced_device_ms`, `replaced_enqueue_us`);
  4. reference — the deployed model, and the classifier serving drain, on
                the card against the same on the CPU (plain versions), at
                smoke size and at full width;
  5. main     — the deployed path at full width (albert_edgebert):
                init_params -> deploy_albert (MLC2 eNVM) -> classify ->
                classify_with_dvfs with a shared-clock arbiter, on 16 seeded
                sentences of 128 tokens, with its kernels' launch counts;
  6. serving  — the serving path at full width (span disabled, MLP weights
                block-pruned at 32x32 tiles): ClassifierServer with a
                BatchedDVFSArbiter serving 32 seeded requests of 8-128
                tokens over buckets (32, 64, 128), with its kernels' launch
                counts, drain times and the device time by kernel.
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

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 rate,
# the fp32 rate outside the tensor cores (where layernorm, softmax_entropy
# and af_quantize compute) and the bf16 tensor-core rate (where af_matmul,
# block_sparse_matmul and span_attention compute their fp32-exact split
# passes).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# bf16 tensor-core passes per fp32 product: x split three ways against
# exact bf16 weights (af_matmul); six split-term products (block_sparse,
# and both products of span_attention)
TC_PASSES = {"af_matmul": 3, "block_sparse_matmul": 6, "span_attention": 6}
# the serving path's length buckets (8 lanes each)
BUCKETS = (32, 64, 128)

RECORD: list = []


def emit(obj) -> None:
    RECORD.append(obj)
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, flops: float, passes: int = 0) -> tuple:
    """The least time for the work, (ms, "bytes" or "operations"): the
    bytes at the HBM rate, or the operations at the rate of their type:
    ``flops`` of fp32 work, or, for a kernel that computes on the tensor
    cores, ``passes`` bf16 products of ``flops`` each."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = passes * flops / BF16_TC_FLOP_PER_S if passes else flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# GPU cycles of the spin that holds the stream while the host enqueues a
# queued timing's calls (~25 ms at the H100's clocks)
SPIN_CYCLES = 50_000_000


def time_ms(fn, iters: int = 50, warmup: int = 3, queued: bool = False) -> float:
    """Time per call from CUDA events over ``iters`` back-to-back calls.
    Where a call's host work (wrapper, launch) outlasts its kernel, the card
    waits for the host and the time is the host's.  ``queued`` first holds
    the stream in a spin kernel while the host enqueues every call, so the
    calls then run without gaps: the device time alone."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def enqueue_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn`` (the wrapper's Python, its checks
    and the launch) while a spin kernel holds the stream, so no call waits
    for the device; the least of three rounds of ``n`` calls."""
    import torch

    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return best


def kernel_times(fn, plain, lib=None, iters: int = 50, enqueue: bool = False) -> dict:
    """A kernel's times beside its plain version's and one library call's:
    back-to-back (``ms``, bounded by the host where its launches outlast the
    kernel) and queued behind a spin (``device_ms``, the card's time alone);
    with ``enqueue`` also the host's cost per call of the kernel's wrapper
    and of the library call."""
    t = {"ms": time_ms(fn, iters), "device_ms": time_ms(fn, iters, queued=True),
         "plain_ms": time_ms(plain, iters),
         "library_ms": None if lib is None else time_ms(lib, iters),
         "library_device_ms": None if lib is None else time_ms(lib, iters, queued=True)}
    if enqueue:
        t["enqueue_us"] = enqueue_us(fn)
        t["library_enqueue_us"] = None if lib is None else enqueue_us(lib)
    return t


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def binade_edges(n_per_side: int = 64, k_range=(-20, 20)):
    """Every float32 within ``n_per_side`` ulp of 2**k, both signs, one row
    group of 32-wide rows per k: [groups * rows, 32] and rows per group."""
    import numpy as np

    groups = []
    for k in range(k_range[0], k_range[1] + 1):
        c = np.float32(2.0 ** k).view(np.int32)
        v = np.arange(c - n_per_side, c + n_per_side + 1, dtype=np.int32).view(np.float32)
        v = np.concatenate([v, -v])
        groups.append(np.concatenate([v, np.zeros((-len(v)) % 32, np.float32)]).reshape(-1, 32))
    return np.concatenate(groups), groups[0].shape[0]


def check_kernels(dep, cfg, sparams, dev) -> list:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.adaptivfloat import af_decode
    from repro_torch.core.early_exit import OfframpParams, offramp_logits
    from repro_torch.kernels import block_sparse, dispatch, ops, ref
    from repro_torch.kernels.adaptivfloat_k import (
        af_matmul,
        group_exp_bias,
        quantize,
        quantize_groups,
    )
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.softmax_entropy import offramp_head, softmax_entropy
    from repro_torch.kernels.span_attention import span_attention_heads
    from repro_torch.serving import deploy

    g = torch.Generator(device=dev).manual_seed(1)
    B, S, d, H, hd = 16, 128, cfg.d_model, cfg.n_heads, cfg.head_dim
    M = B * S
    rows = []

    def row(name, source, replaces, shape, err, tol, ok, n_bytes, flops, *, ms, plain_ms, library_ms,
            device_ms, library_device_ms=None, summary=True, label="serving", **detail):
        """Emit and check one kernel row; ``summary`` rows (one per kernel)
        go to the kernels line, the others check further shapes.  For the
        tensor-core kernels the row also gives the same work's time at the
        fp32 rate (``fp32_rate_ms``, not a bound for them)."""
        passes = TC_PASSES.get(name, 0)
        b_ms, b_by = bound_ms(n_bytes, flops, passes)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "shape": shape, "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
             "device_ms": device_ms, "library_device_ms": library_device_ms}
        if passes:
            detail["fp32_rate_ms"] = bound_ms(n_bytes, flops)[0]
        emit({"phase": "kernel", **r, **({} if summary else {"row": f"{name}@{label}"}), **detail})
        if not ok:
            raise AssertionError(f"{name} ({shape}): kernel and plain version disagree beyond {tol} "
                                 f"(max abs error {err})")
        if summary:
            rows.append(r)

    # layernorm [2048, 768]
    x = torch.randn(M, d, generator=g, device=dev) * 3.0
    gam = dep.layer["norm1_scale"] + 0.1 * torch.randn(d, generator=g, device=dev)
    bet = 0.1 * torch.randn(d, generator=g, device=dev)
    err = (layernorm(x, gam, bet) - ref.layernorm(x, gam, bet)).abs().max().item()
    row("layernorm", "src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/layernorm.py:17",
        f"[{M}, {d}] fp32", err, "atol 1e-5", err <= 1e-5, (2 * M * d + 2 * d) * 4, 8 * M * d,
        **kernel_times(lambda: layernorm(x, gam, bet), lambda: ref.layernorm(x, gam, bet),
                       lambda: F.layer_norm(x, (d,), gam, bet, eps=1e-6), enqueue=True))
    # ... and at the serving step's [8 lanes x S, 768] for each bucket S
    for S_b in BUCKETS:
        xs_ = torch.randn(8 * S_b, d, generator=g, device=dev) * 3.0
        err = (layernorm(xs_, gam, bet) - ref.layernorm(xs_, gam, bet)).abs().max().item()
        row("layernorm", "src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/layernorm.py:17",
            f"[{8 * S_b}, {d}] fp32", err, "atol 1e-5", err <= 1e-5,
            (2 * 8 * S_b * d + 2 * d) * 4, 8 * 8 * S_b * d,
            **kernel_times(lambda: layernorm(xs_, gam, bet), lambda: ref.layernorm(xs_, gam, bet),
                           lambda: F.layer_norm(xs_, (d,), gam, bet, eps=1e-6), enqueue=True),
            summary=False)

    # softmax_entropy as the off-ramp head, one launch for pooler, classifier,
    # softmax entropy and retire: the serving step's [8 lanes, 768] on fp32
    # weights (the summary row) and the deployed [16, 768] on AF8 codes, the
    # CLS rows read by stride from [lanes, 128, 768] hidden states.  Beside
    # each, the chain it replaces, run as the paths ran it before
    # (`replaced_*`): gemm, add, tanh, gemm, add, the softmax-entropy kernel
    # and the retire compare (serving); two af_matmul launches on a copy of
    # the CLS rows, add, tanh, add and the softmax-entropy kernel (deployed).
    # Logits and entropies within 1e-5 of the plain version, retire equal
    # wherever the entropy lies 1e-4 or more from the threshold (the median).
    # the card's floor for one small launch: an empty kernel (a spin of 0
    # cycles), queued back to back like every `device_ms`
    launch_floor = time_ms(lambda: torch.cuda._sleep(0), iters=100, queued=True)
    C = cfg.edgebert.early_exit.num_classes
    so = sparams["offramp"]
    serv_w = OfframpParams(*(so[k].to(dev).float().contiguous() for k in (
        "offramp_pooler_w", "offramp_pooler_b", "offramp_cls_w", "offramp_cls_b")))
    off = dep.offramp
    for label, Bh, af in (("serving", 8, False), ("deployed", B, True)):
        hh = torch.randn(Bh, S, d, generator=g, device=dev)
        act = torch.arange(Bh, device=dev) % 4 != 1
        if af:
            pw, pb, cw, cb = off["pooler_w"], off["pooler_b"], off["cls_w"], off["cls_b"]
            args, e_min = (pw.codes, pb, cw.codes, cb), (pw.e_min, cw.e_min)
            w_bytes = d * d + d * C
            act = None

            def chain(hh=hh):
                pooled = torch.tanh(deploy._mm(hh[:, 0, :], off["pooler_w"]) + off["pooler_b"])
                lg = deploy._mm(pooled, off["cls_w"]) + off["cls_b"]
                return lg, ops.softmax_entropy_op(lg)[1]
        else:
            args, e_min = tuple(serv_w), None
            w_bytes = (d * d + d * C) * 4

            def chain(hh=hh, act=act):
                lg = offramp_logits(hh, serv_w)
                ent = ops.softmax_entropy_op(lg)[1]
                return lg, ent, act & (ent < thr)

        want = ref.offramp_head(hh, *args, act, 0.0, e_min)
        thr = float(want[:, C].median())
        want = ref.offramp_head(hh, *args, act, thr, e_min)
        got = offramp_head(hh, *args, active=act, threshold=thr, e_min=e_min)
        err = (got[:, :C + 1] - want[:, :C + 1]).abs().max().item()
        clear = (want[:, C] - thr).abs() >= 1e-4
        retire_ok = torch.equal(got[:, C + 1][clear], want[:, C + 1][clear])
        chain_out = chain()
        chain_err = max((got[:, :C] - chain_out[0]).abs().max().item(),
                        (got[:, C] - chain_out[1]).abs().max().item())
        n_bytes = Bh * d * 4 + w_bytes + (d + C) * 4 + Bh + Bh * (C + 2) * 4
        flops = 2.0 * Bh * d * d + 2.0 * Bh * d * C + 12.0 * Bh * C
        row("softmax_entropy", "src/repro_torch/csrc/softmax_entropy.cu",
            "src/repro/kernels/softmax_entropy.py:17",
            f"off-ramp head, {label}: h [{Bh}, {S}, {d}] by stride, pooler {d}x{d} + classifier {d}x{C} "
            f"{'AF8 codes' if af else 'fp32'}, packed [{Bh}, {C + 2}]", err,
            "atol 1e-5 (logits, entropy); retire equal 1e-4 from the threshold",
            err <= 1e-5 and retire_ok and chain_err <= 1e-5, n_bytes, flops,
            **kernel_times(lambda: offramp_head(hh, *args, active=act, threshold=thr, e_min=e_min),
                           lambda: ref.offramp_head(hh, *args, act, thr, e_min), enqueue=True),
            replaced_ms=time_ms(chain), replaced_device_ms=time_ms(chain, queued=True),
            replaced_enqueue_us=enqueue_us(chain), replaced_max_abs_err=chain_err,
            retire_equal=retire_ok, retire_compared=int(clear.sum()), launch_floor_device_ms=launch_floor,
            summary=label == "serving", label=label)

    # ... and given logits (+ mask), the TPU kernel's own function: [16, 3]
    # and the serving step's [8 lanes, 3]
    for rows_ in (B, 8):
        lg = torch.randn(rows_, C, generator=g, device=dev) * 2.0
        mk = (torch.rand(rows_, C, generator=g, device=dev) > 0.3).float()
        err = 0.0
        for m_ in (None, mk):
            p, h = softmax_entropy(lg, m_)
            rp, rh = ref.softmax_entropy(lg, m_)
            err = max(err, (p - rp).abs().max().item(), (h - rh).abs().max().item())
        row("softmax_entropy", "src/repro_torch/csrc/softmax_entropy.cu",
            "src/repro/kernels/softmax_entropy.py:17", f"logits [{rows_}, {C}] fp32 (+ mask)", err,
            "atol 1e-6", err <= 1e-6, (2 * rows_ * C + rows_) * 4, 10 * rows_ * C,
            **kernel_times(lambda: softmax_entropy(lg), lambda: ref.softmax_entropy(lg)), summary=False,
            label=f"logits[{rows_}]")

    # af_matmul on the deployed codes: one encoder layer's six matmuls at
    # M = 2048 (the summary row), at M = 512 and 128 (later layers, fewer
    # active sentences: the split-K route), and the embed projection at
    # M = 2048 (the off-ramp's two matmuls now run inside the off-ramp head)
    xs = torch.randn(M, max(d, cfg.d_ff), generator=g, device=dev)
    af_cases = [(M, "layer", [(n, dep.layer[n]) for n in ("wq", "wk", "wv", "wo", "w_up", "w_down")]),
                (512, "layer@M=512", [(n, dep.layer[n]) for n in ("wq", "wk", "wv", "wo", "w_up", "w_down")]),
                (128, "layer@M=128", [(n, dep.layer[n]) for n in ("wq", "wk", "wv", "wo", "w_up", "w_down")])]
    if dep.embed_proj is not None:
        af_cases.append((M, "embed_proj", [("embed_proj", dep.embed_proj)]))
    for Mx, label, weights in af_cases:
        ms = plain = lib = n_bytes = flops = err = dev_ms = lib_dev = 0.0
        ok = True
        shapes = []
        per_shape = {}
        for name, w in weights:
            K, N = w.codes.shape
            xk = xs[:Mx, :K].contiguous()
            want = ref.af_matmul(xk, w.codes, w.e_min)
            got = af_matmul(xk, w.codes, w.e_min)
            err = max(err, (got - want).abs().max().item())
            ok = ok and torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            w_dec = af_decode(w.codes, w.e_min)
            t = (time_ms(lambda: af_matmul(xk, w.codes, w.e_min), iters=20),
                 time_ms(lambda: ref.af_matmul(xk, w.codes, w.e_min), iters=20),
                 time_ms(lambda: torch.matmul(xk, w_dec), iters=20),
                 time_ms(lambda: af_matmul(xk, w.codes, w.e_min), iters=20, queued=True),
                 time_ms(lambda: torch.matmul(xk, w_dec), iters=20, queued=True))
            nb, nf = Mx * K * 4 + K * N + Mx * N * 4, 2.0 * Mx * K * N
            per_shape[name] = {"K": K, "N": N, "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                               "device_ms": t[3], "library_device_ms": t[4],
                               "bound_ms": bound_ms(nb, nf, TC_PASSES["af_matmul"])[0],
                               "fp32_rate_ms": bound_ms(nb, nf)[0]}
            ms, plain, lib = ms + t[0], plain + t[1], lib + t[2]
            dev_ms, lib_dev = dev_ms + t[3], lib_dev + t[4]
            n_bytes, flops = n_bytes + nb, flops + nf
            shapes.append(f"{K}x{N}")
        row("af_matmul", "src/repro_torch/csrc/af_matmul.cu", "src/repro/kernels/adaptivfloat_k.py:99",
            f"M={Mx}, {label}: {' + '.join(shapes)} (times and bounds summed)", err,
            "rtol 1e-5 + atol 1e-5", ok, n_bytes, flops, ms=ms, plain_ms=plain, library_ms=lib,
            device_ms=dev_ms, library_device_ms=lib_dev, summary=label == "layer", label=label,
            per_shape=per_shape)

    # span_attention through the wrapper the paths run, called as they call
    # it: [B, S, H, dh] activations read through permuted [B, H, S, dh] views
    # and the result written into a fresh [B, S, H, dh] tensor, with per-head
    # spans (ops.span_attention_op, every head live) or per-lane kv_lens
    # (dispatch.dense_attention).  The plain version and SDPA take the same
    # views.
    def heads_call(q4, k4, v4, spans_t, window, kv_lens=None):
        out = torch.empty_like(q4)
        span_attention_heads(q4.permute(0, 2, 1, 3), k4.permute(0, 2, 1, 3), v4.permute(0, 2, 1, 3), spans_t,
                             window, causal=False, kv_lens=kv_lens, out=out.permute(0, 2, 1, 3))
        return out

    def heads(t):
        return t.permute(0, 2, 1, 3)

    # deployed: 16 sentences x 12 live heads, S = 128, dh = 64
    spans_np = np.asarray(dep.spans, np.int32)
    window = int(spans_np.max())
    q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev) for _ in range(3))
    spans = torch.as_tensor(spans_np, device=dev)
    want = ref.span_attention(heads(q).cpu(), heads(k).cpu(), heads(v).cpu(), spans.cpu(), causal=False)
    got = heads(heads_call(q, k, v, spans, window))
    err = (got.cpu() - want).abs().max().item()
    dist = np.abs(np.arange(S)[:, None] - np.arange(S)[None, :])
    pairs = B * sum(int((dist < s).sum()) for s in spans_np)
    mask = torch.as_tensor(dist[None] < spans_np[:, None, None], device=dev)
    row("span_attention", "src/repro_torch/csrc/span_attention.cu",
        "src/repro/kernels/span_attention.py:32",
        f"B={B}, S={S}, H={H}, dh={hd}, window={window}, bidirectional, [B, S, H, dh] views", err,
        "atol 2e-5", err <= 2e-5, 4 * B * H * S * hd * 4 + H * 4, 4.0 * hd * pairs,
        **kernel_times(lambda: heads_call(q, k, v, spans, window),
                       lambda: ref.span_attention(heads(q), heads(k), heads(v), spans, causal=False),
                       lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask),
                       enqueue=True))

    # serving: window = S, no spans, one kv_len per lane, 8 lanes x 12 heads;
    # the keys at or past a lane's kv_len are neither read nor needed
    for Sb in BUCKETS[::-1]:
        lanes = 8
        qs, ks, vs = (torch.randn(lanes, Sb, H, hd, generator=g, device=dev) for _ in range(3))
        lens_np = np.random.default_rng(Sb).integers(1, Sb + 1, lanes).astype(np.int32)
        lens = torch.as_tensor(lens_np, device=dev)
        full = torch.full((H,), Sb, dtype=torch.int32)
        full_d = full.to(dev)
        want = ref.span_attention(heads(qs).cpu(), heads(ks).cpu(), heads(vs).cpu(), full, causal=False,
                                  kv_lens=lens.cpu()[:, None].expand(-1, H))
        got = heads(heads_call(qs, ks, vs, None, Sb, lens))
        err = (got.cpu() - want).abs().max().item()
        kmask = torch.as_tensor(np.arange(Sb)[None, None, None, :] < lens_np[:, None, None, None], device=dev)
        key_rows = H * int(lens_np.sum())
        row("span_attention", "src/repro_torch/csrc/span_attention.cu",
            "src/repro/kernels/span_attention.py:32",
            f"serving: B={lanes}, S={Sb}, H={H}, dh={hd}, window={Sb}, kv_lens in [1, {Sb}], "
            "[B, S, H, dh] views", err, "atol 2e-5", err <= 2e-5,
            (2 * lanes * H * Sb * hd + 2 * hd * key_rows) * 4 + lanes * 4, 4.0 * hd * Sb * key_rows,
            **kernel_times(lambda: heads_call(qs, ks, vs, None, Sb, lens),
                           lambda: ref.span_attention(heads(qs), heads(ks), heads(vs), full_d,
                                                      causal=False, kv_lens=lens[:, None].expand(-1, H)),
                           lambda: F.scaled_dot_product_attention(heads(qs), heads(ks), heads(vs),
                                                                  attn_mask=kmask),
                           enqueue=True),
            summary=False)

    # af_quantize through quantize_groups, the serving path's one launch
    # (amax, bias and quantize): the serving step's [8 lanes x S, 768]
    # activations at each bucket S, one bias per lane; at S = 128 also every
    # float32 within 64 ulp of 2**k, k in [-20, 20], through the same
    # launch (one group per k) and through `quantize` with the biases
    # given; atol 0 and equal biases against the plain version run on the
    # CPU (group_exp_bias + ref.quantize).  Beside it the chain it replaces
    # (`replaced_*`): group_exp_bias's PyTorch ops, then `quantize`; and a
    # PyTorch copy of the same tensor (`copy_device_ms`: one read and one
    # write, what the bound counts).  The summary row is S = 128, the
    # others are extra rows.
    lanes = 8
    edges, rpg = binade_edges()
    xe = torch.from_numpy(edges)
    e_edges = group_exp_bias(xe, rpg)
    for S_b in BUCKETS[::-1]:
        xa = torch.randn(lanes * S_b, d, generator=g, device=dev) * 2.0
        xa[3 * S_b:4 * S_b] *= 1e-3
        xa[6 * S_b - S_b // 4:6 * S_b] *= 50.0
        e_cpu = group_exp_bias(xa.cpu(), S_b)
        q, e_min = quantize_groups(xa, S_b)
        err = (q.cpu() - ref.quantize(xa.cpu(), e_cpu, S_b)).abs().max().item()
        ok = torch.equal(e_min.cpu(), e_cpu)
        shape = f"[{lanes * S_b}, {d}] fp32, {lanes} row groups of {S_b}"
        if S_b == BUCKETS[-1]:
            qe, ee = quantize_groups(xe.to(dev), rpg)
            ok = ok and torch.equal(ee.cpu(), e_edges)
            err = max(err, (qe.cpu() - ref.quantize(xe, e_edges, rpg)).abs().max().item(),
                      (quantize(xe.to(dev), e_edges.to(dev), rpg).cpu()
                       - ref.quantize(xe, e_edges, rpg)).abs().max().item())
            shape += f"; + {edges.shape[0]}x32 binade edges"
        n = xa.numel()

        def chain(xa=xa, S_b=S_b):
            return quantize(xa, group_exp_bias(xa, S_b), S_b)

        copy_to = torch.empty_like(xa)

        row("af_quantize", "src/repro_torch/csrc/af_quantize.cu", "src/repro/kernels/adaptivfloat_k.py:41",
            shape, err, "atol 0 and equal biases (against the CPU plain version)", ok and err == 0.0,
            2 * n * 4 + lanes * 4, 20.0 * n,
            **kernel_times(lambda: quantize_groups(xa, S_b), lambda: ref.quantize(xa, e_min, S_b),
                           enqueue=True),
            replaced_ms=time_ms(chain), replaced_device_ms=time_ms(chain, queued=True),
            replaced_enqueue_us=enqueue_us(chain),
            launch_floor_device_ms=launch_floor,
            copy_device_ms=time_ms(lambda: copy_to.copy_(xa), queued=True),
            summary=S_b == BUCKETS[-1], label=f"S={S_b}")

    # block_sparse_matmul: the pruned MLP weights at M = 8 lanes x S for
    # each bucket S (the summary row is M = 1024)
    # the weights on the card, and their indices with the tiles packed from
    # them (the kernel takes an index only with the weight it was packed from)
    mlp = {k: v.to(dev).float().contiguous() for k, v in sparams["layer"]["mlp"].items()}
    masks = dispatch.mlp_block_masks(mlp)
    for S_b in BUCKETS[::-1]:
        Mb = lanes * S_b
        ms = plain = lib = n_bytes = flops = err = dev_ms = lib_dev = 0.0
        ok = True
        per_shape = {}
        shapes = []
        for name in ("w_up", "w_down"):
            w, m = mlp[name], masks[name]
            if m is None:
                raise AssertionError(f"{name} is not block-pruned")
            K, N = w.shape
            xk = torch.randn(Mb, K, generator=g, device=dev)
            want = ref.block_sparse_matmul(xk, w, m.mask, m.bk, m.bn)
            got = block_sparse.block_sparse_matmul(xk, w, m)
            err = max(err, (got - want).abs().max().item())
            ok = ok and torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            t = (time_ms(lambda: block_sparse.block_sparse_matmul(xk, w, m), iters=20),
                 time_ms(lambda: ref.block_sparse_matmul(xk, w, m.mask, m.bk, m.bn), iters=20),
                 time_ms(lambda: torch.matmul(xk, w), iters=20),
                 time_ms(lambda: block_sparse.block_sparse_matmul(xk, w, m), iters=20, queued=True),
                 time_ms(lambda: torch.matmul(xk, w), iters=20, queued=True))
            tiles = m.occupied
            nb = Mb * K * 4 + tiles * m.bk * m.bn * 4 + m.indices.numel() * 4 + Mb * N * 4
            nf = 2.0 * Mb * tiles * m.bk * m.bn
            per_shape[name] = {"K": K, "N": N, "occupied_tiles": tiles, "tiles": int(m.mask.size),
                               "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                               "device_ms": t[3], "library_device_ms": t[4],
                               "bound_ms": bound_ms(nb, nf, TC_PASSES["block_sparse_matmul"])[0],
                               "fp32_rate_ms": bound_ms(nb, nf)[0]}
            ms, plain, lib = ms + t[0], plain + t[1], lib + t[2]
            dev_ms, lib_dev = dev_ms + t[3], lib_dev + t[4]
            n_bytes, flops = n_bytes + nb, flops + nf
            shapes.append(f"{K}x{N} ({tiles}/{m.mask.size} tiles)")
        row("block_sparse_matmul", "src/repro_torch/csrc/block_sparse.cu", "src/repro/kernels/block_sparse.py:42",
            f"M={Mb}: {' + '.join(shapes)} at 32x32 tiles (times and bound summed; bound on occupied tiles)",
            err, "rtol 1e-5 + atol 1e-5", ok, n_bytes, flops, ms=ms, plain_ms=plain, library_ms=lib,
            device_ms=dev_ms, library_device_ms=lib_dev, summary=S_b == BUCKETS[-1],
            per_shape=per_shape)

    check_determinism(dep, masks, mlp, dev)
    return rows


def check_determinism(dep, masks, mlp, dev) -> None:
    """Each kernel twice on the same inputs must give the same bits: the
    matmuls at every M whose grid takes a different split-K route (the
    clusters reduce their partials in rank order, without atomics), the
    other kernels at their main shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.adaptivfloat_k import af_matmul, group_exp_bias, quantize, quantize_groups
    from repro_torch.kernels.block_sparse import block_sparse_matmul
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.softmax_entropy import offramp_head, softmax_entropy
    from repro_torch.kernels.span_attention import span_attention, span_attention_heads

    g = torch.Generator(device=dev).manual_seed(2)
    checked = {}

    def same(name, fn):
        a, b = fn(), fn()
        a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
        checked[name] = all(torch.equal(u, v) for u, v in zip(a, b))

    for Mx in (2048, 512, 128, 16):
        for name in ("w_up", "w_down"):
            w = dep.layer[name]
            xk = torch.randn(Mx, w.codes.shape[0], generator=g, device=dev)
            same(f"af_matmul M={Mx} {name}", lambda: af_matmul(xk, w.codes, w.e_min))
    for Mx in (1024, 512, 256):
        for name in ("w_up", "w_down"):
            w = mlp[name]
            xk = torch.randn(Mx, w.shape[0], generator=g, device=dev)
            same(f"block_sparse_matmul M={Mx} {name}", lambda: block_sparse_matmul(xk, w, masks[name]))
    x = torch.randn(2048, 768, generator=g, device=dev)
    gam, bet = torch.randn(768, generator=g, device=dev), torch.randn(768, generator=g, device=dev)
    same("layernorm", lambda: layernorm(x, gam, bet))
    lg = torch.randn(16, 3, generator=g, device=dev)
    same("softmax_entropy", lambda: softmax_entropy(lg))
    # the off-ramp head: its partials are summed in block order by whichever
    # block ends last, on fp32 weights (serving, with an active mask) and on
    # the deployed AF8 codes
    hh = torch.randn(16, 128, 768, generator=g, device=dev)
    act = torch.arange(16, device=dev) % 3 != 0
    pw, pb = torch.randn(768, 768, generator=g, device=dev) * 0.03, torch.randn(768, generator=g, device=dev)
    cw, cb = torch.randn(768, 3, generator=g, device=dev) * 0.03, torch.randn(3, generator=g, device=dev)
    same("softmax_entropy off-ramp head fp32", lambda: offramp_head(hh[:8], pw, pb, cw, cb, active=act[:8],
                                                                    threshold=1.0))
    same("softmax_entropy off-ramp head AF8", lambda: ops.offramp_head_op(hh, dep.offramp))
    e_min = group_exp_bias(x[:1024], 128)
    same("af_quantize", lambda: quantize(x[:1024].contiguous(), e_min, 128))
    for S_b in BUCKETS:
        same(f"af_quantize groups of {S_b} rows", lambda: quantize_groups(x[:8 * S_b].contiguous(), S_b))
    same("af_quantize one group of 2048 rows (read twice)", lambda: quantize_groups(x, 2048))
    q, k, v = (torch.randn(192, 128, 64, generator=g, device=dev) for _ in range(3))
    spans = torch.as_tensor(np.full(192, 64, np.int32), device=dev)
    same("span_attention", lambda: span_attention(q, k, v, spans, 64, causal=False))
    lens = torch.as_tensor(np.random.default_rng(3).integers(1, 129, 192).astype(np.int32), device=dev)
    same("span_attention kv_lens", lambda: span_attention(q, k, v, spans, 64, causal=False, kv_lens=lens))
    # the strided route: [B, S, H, dh] views in, a [B, S, H, dh] tensor out
    qs, ks, vs = (torch.randn(16, 128, 12, 64, generator=g, device=dev) for _ in range(3))
    lane_lens = lens[:16].contiguous()

    def strided():
        out = torch.empty_like(qs)
        span_attention_heads(qs.permute(0, 2, 1, 3), ks.permute(0, 2, 1, 3), vs.permute(0, 2, 1, 3), None,
                             128, causal=False, kv_lens=lane_lens, out=out.permute(0, 2, 1, 3))
        return out

    same("span_attention strided [B, S, H, dh]", strided)

    def strided_spans():
        out = torch.empty_like(qs)
        span_attention_heads(qs.permute(0, 2, 1, 3), ks.permute(0, 2, 1, 3), vs.permute(0, 2, 1, 3), head_spans,
                             64, causal=False, out=out.permute(0, 2, 1, 3))
        return out

    head_spans = spans[:12].contiguous()
    same("span_attention strided [B, S, H, dh], per-head spans", strided_spans)
    emit({"phase": "determinism", "bitwise_equal": checked})
    if not all(checked.values()):
        raise AssertionError(f"repeated launches differ: {[k for k, v in checked.items() if not v]}")


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


def serving_config(cfg, span: bool):
    """The serving configuration: float32 params, as the JAX package's
    serving tests and launch/serve.py use them, span on or off."""
    import dataclasses

    return dataclasses.replace(cfg, dtype="float32").with_edgebert(
        span=dataclasses.replace(cfg.edgebert.span, enabled=span))


def serving_params(cfg, seed: int, prune: bool):
    """Random params from ``seed`` on the CPU; with ``prune`` the shared
    layer's w_up/w_down are magnitude-pruned in one shot at the config's
    encoder sparsity in 32x32 tiles (configs/base.py PruneConfig), the mask
    applied to the weights."""
    import torch

    from repro_torch.core.pruning import magnitude_mask
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    if prune:
        mlp = params["layer"]["mlp"]
        for name in ("w_up", "w_down"):
            mlp[name] = mlp[name] * magnitude_mask(mlp[name], cfg.edgebert.prune.encoder_sparsity,
                                                   block_size=32)
    return params


def serving_requests(cfg, n: int, max_len: int, seed: int = 0):
    """``n`` SyntheticCLS sentences (seed ``seed``), each cut to a length
    drawn from [8, max_len] with numpy.random.default_rng(seed)."""
    import numpy as np

    from repro_torch.data.synthetic import SyntheticCLS

    toks = SyntheticCLS(cfg.vocab_size, max_len, n, num_classes=cfg.edgebert.early_exit.num_classes,
                        seed=seed).batch(0)["tokens"]
    lens = np.random.default_rng(seed).integers(8, max_len + 1, n)
    return [toks[i][: int(lens[i])] for i in range(n)]


def make_server(cfg, params, dev, *, buckets, lanes=8, threshold=None, **kw):
    """A ClassifierServer on ``dev`` (its set-up: params moved to the
    device, block masks and their CSR index built from the weights)."""
    import dataclasses

    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ClassifierServer

    if threshold is not None:
        cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                               entropy_threshold=threshold))
    return ClassifierServer(build_model(cfg), params, batch_lanes=lanes, buckets=buckets,
                            device=dev, **kw)


def serve(srv, requests):
    """Submit ``requests`` and drain them; returns the server."""
    from repro_torch.serving.engine import Request

    for i, t in enumerate(requests):
        srv.submit(Request(uid=i, tokens=t))
    srv.run()
    return srv


def drain(cfg, params, requests, dev, **kw):
    """One ClassifierServer drain of ``requests``; returns the server."""
    return serve(make_server(cfg, params, dev, **kw), requests)


def gap_threshold(entropies, min_gap=1e-3):
    """Midpoint of the gap nearest the median of the observed entropies that
    is wider than 2 * min_gap: no entropy lies within min_gap of it, so
    float32 noise between the card and the CPU cannot flip an exit."""
    import numpy as np

    e = np.unique(np.asarray(entropies, np.float64))
    mids = [(a + b) / 2 for a, b in zip(e, e[1:]) if b - a > 2 * min_gap]
    if not mids:
        raise AssertionError("no gap of 2e-3 between observed entropies")
    return float(min(mids, key=lambda m: abs(m - np.median(e))))


PRE_QUANT_ATOL = 1e-5


def af_next_step(lo, e_lo, fmt):
    """Distance from each AF grid value ``lo`` >= 0 to the next one up, on
    the grid of bias ``e_lo`` (broadcast): from 0 the smallest normal
    value, else one quantum of ``lo``'s binade (ref.quantize's grid)."""
    import torch

    from repro_torch.core.adaptivfloat import exact_pow2

    e = (torch.frexp(lo)[1] - 1).float()
    e = torch.minimum(torch.maximum(e, e_lo), e_lo + (fmt.n_levels_exp - 1))
    min_pos = exact_pow2(e_lo) * (1.0 + 2.0 ** -fmt.n_mant)
    return torch.where(lo == 0, min_pos, exact_pow2(e - fmt.n_mant))


def quant_flips(cfg, params, requests, dev, bucket: int) -> dict:
    """Layer by layer on the CPU's state (teacher forcing): the serving
    layer step before activation quantization on the card and on the CPU,
    at one ``bucket``, then the per-lane AF quantization of each.  The two
    pre-quantization tensors must agree within PRE_QUANT_ATOL and give
    every lane the same bias.  A quantized element that differs is a flip:
    it must be one step between neighbouring grid points whose midpoint
    lies within the pre-quantization difference of the CPU's value, so the
    two values straddle an AF rounding boundary.  Every other element must
    be equal."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.core.adaptivfloat import AFFormat
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.adaptivfloat_k import quantize_groups
    from repro_torch.models.model import build_model

    q = cfg.edgebert.quant
    fmt = AFFormat(q.n_bits, q.n_exp)
    model = build_model(cfg.with_edgebert(quant=dataclasses.replace(q, quantize_activations=False)))
    lanes, D = len(requests), cfg.d_model
    toks = np.zeros((lanes, bucket), np.int64)
    lens = np.array([len(t) for t in requests], np.int32)
    for i, t in enumerate(requests):
        toks[i, : len(t)] = t
    valid = torch.as_tensor(np.arange(bucket)[None, :] < lens[:, None])       # [lanes, S]
    sides = {}
    for d in ("cpu", dev):
        p = tree_to(params, torch.device(d))
        sides[str(d)] = (p, dispatch.mlp_block_masks(p["layer"]["mlp"]), torch.as_tensor(lens).to(d))
    h = model.embed(sides["cpu"][0], torch.as_tensor(toks)).float()
    per_layer = []
    for layer in range(cfg.n_layers):
        outs = {}
        for d, (p, masks, kv) in sides.items():
            with torch.no_grad():
                pre = model._dense_layer_step(p["layer"], h.to(d), causal=False, kv_len=kv,
                                              use_kernels=True, block_masks=masks, per_lane=True)
                # the path's quantization (dispatch.act_quantize) is this
                # call; on the card its biases come from the kernel
                qd, ed = quantize_groups(pre.reshape(-1, D).contiguous(), bucket, fmt=fmt)
                outs[d] = (pre.cpu(), qd.reshape(pre.shape).cpu(), ed.cpu())
        (pre_c, q_c, e_c), (pre_g, q_g, e_g) = outs["cpu"], outs[str(dev)]
        pre_err = (pre_g - pre_c).abs()
        flip = (q_g != q_c) & valid[..., None]
        lo = torch.minimum(q_g.abs(), q_c.abs())
        step = af_next_step(lo, e_c.float()[:, None, None], fmt)
        one_step = ((q_g * q_c >= 0) & (lo + step == torch.maximum(q_g.abs(), q_c.abs()))) | ~flip
        mid = (q_g + q_c) / 2
        at_boundary = ((pre_c - mid).abs() <= pre_err + 1e-7 * pre_c.abs()) | ~flip
        r = {"layer": layer + 1, "flips": int(flip.sum()), "elements": int(valid.sum()) * D,
             "pre_quant_max_abs_err": float(pre_err[valid].max()),
             "flip_max_abs": float((q_g - q_c)[flip].abs().max()) if flip.any() else 0.0,
             "biases_equal": bool(torch.equal(e_c, e_g)),
             "all_one_step": bool(one_step.all()), "all_at_boundary": bool(at_boundary.all())}
        per_layer.append(r)
        if not (r["pre_quant_max_abs_err"] <= PRE_QUANT_ATOL and r["biases_equal"]):
            raise AssertionError(f"bucket {bucket}, layer {layer + 1}: the layer step before "
                                 f"quantization differs beyond {PRE_QUANT_ATOL} or moves a lane's bias: {r}")
        if not (r["all_one_step"] and r["all_at_boundary"]):
            raise AssertionError(f"bucket {bucket}, layer {layer + 1}: a quantized element differs "
                                 f"by more than one grid step or away from an AF boundary: {r}")
        h = q_c
    return {"bucket": bucket, "flips": sum(r["flips"] for r in per_layer),
            "elements": sum(r["elements"] for r in per_layer),
            "pre_quant_max_abs_err": max(r["pre_quant_max_abs_err"] for r in per_layer),
            "pre_quant_atol": PRE_QUANT_ATOL,
            "flip_max_abs": max(r["flip_max_abs"] for r in per_layer), "per_layer": per_layer}


def check_serving_reference(cfg_full, sparams_full, dev) -> None:
    """The classifier serving drain on the card (kernel route) against the
    same drain on the CPU (plain versions): exits equal, logits within 1e-4
    at smoke size (span on: the soft-span reference attention; span off
    with a block-pruned MLP: the kernels).  At full width, activation
    quantization flips a few elements per layer where the two sides' float32
    sums straddle an AF rounding boundary (``quant_flips``, at each bucket,
    holds the layer step before quantization to PRE_QUANT_ATOL and checks
    that every difference is a one-step flip at a boundary), and twelve
    layers carry the flips to the logits: 5e-2 there (PERF.md records the
    flips and the logit error they cause)."""
    import numpy as np

    from repro_torch.configs.base import get_smoke_config

    smoke = get_smoke_config("albert_edgebert")
    cases = []
    for span in (True, False):
        scfg = serving_config(smoke, span)
        cases.append((f"smoke_span_{'on' if span else 'off_pruned'}", scfg,
                      serving_params(scfg, 3, prune=not span),
                      serving_requests(scfg, 12, 32, seed=1), (16, 32), 4, 1e-4, True))
    # full width: a short drain at full depth (threshold 0)
    cases.append(("full_span_off_pruned", cfg_full, sparams_full,
                  serving_requests(cfg_full, 8, 128, seed=2), BUCKETS, 8, 5e-2, False))
    for name, cfg, params, reqs, buckets, lanes, tol, pick in cases:
        thr = 0.0
        if pick:
            prof = drain(cfg, params, reqs, "cpu", buckets=buckets, lanes=lanes, threshold=0.0)
            thr = gap_threshold(np.concatenate([prof.done[i].entropy_trace for i in range(len(reqs))]))
        on_card = drain(cfg, params, reqs, dev, buckets=buckets, lanes=lanes, threshold=thr)
        on_cpu = drain(cfg, params, reqs, "cpu", buckets=buckets, lanes=lanes, threshold=thr)
        n = len(reqs)
        exits_card = [on_card.done[i].exit_layer for i in range(n)]
        exits_cpu = [on_cpu.done[i].exit_layer for i in range(n)]
        err = max(float(np.abs(on_card.done[i].result - on_cpu.done[i].result).max()) for i in range(n))
        trace_err = max(float(np.abs(np.subtract(on_card.done[i].entropy_trace,
                                                 on_cpu.done[i].entropy_trace)).max())
                        if len(on_card.done[i].entropy_trace) == len(on_cpu.done[i].entropy_trace)
                        else float("inf") for i in range(n))
        flips = ([quant_flips(cfg, params, [t[:S] for t in reqs], dev, S) for S in buckets]
                 if name.startswith("full") else None)
        emit({"phase": "reference", "config": f"serving_{name}", "requests": n,
              "buckets": list(buckets), "threshold": thr, "exit_layers": exits_card,
              "logits_max_abs_err": err, "trace_max_abs_err": trace_err, "tolerance": tol,
              "quant_flips": flips})
        if not (exits_card == exits_cpu and err <= tol and trace_err <= tol):
            raise AssertionError(f"card and CPU serving drains disagree on {name}")


KERNEL_SYMBOLS = {
    "af_matmul_kernel": "af_matmul",
    "af_quantize_groups_kernel": "af_quantize",
    "offramp_head_kernel": "softmax_entropy",
    "span_attention_kernel": "span_attention",
    "layernorm_kernel": "layernorm",
    "softmax_entropy_kernel": "softmax_entropy",
    "af_quantize_kernel": "af_quantize",
    "block_sparse_kernel": "block_sparse_matmul",
    "Memcpy": "memcpy",
}


def profile_device(fn) -> dict:
    """Device time by kernel over one call of ``fn``, from torch.profiler's
    CUDA activity (the port's kernels by name, the rest of PyTorch's
    kernels as "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
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
    from repro_torch.serving.dvfs import (
        BatchedDVFSArbiter,
        default_albert_controller,
        no_early_exit_baseline,
    )

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

    # the deployed path, counted: one early-exit batch under the
    # shared-clock arbiter (one (V, f) per layer step across the batch)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, exits, lane_reports = dep.classify_with_dvfs(
        tokens, controller, arbiter=BatchedDVFSArbiter(controller))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    # the per-sentence Alg. 1 replay of the same batch (not counted)
    _, exits_ps, reports = dep.classify_with_dvfs(tokens, controller)
    if not np.array_equal(exits_ps, exits) or len(lane_reports) != B:
        raise AssertionError("the arbiter and per-sentence DVFS runs disagree")

    if not np.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    if not ((exits >= 1) & (exits <= cfg.n_layers)).all():
        raise AssertionError(f"exit layers out of range: {exits}")
    if not np.array_equal(exits, profile_exits):
        raise AssertionError(f"exits {exits} differ from the profile's {profile_exits}")
    missing = [k for k in ops.DEPLOY_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the deployed path: {missing}")

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
    dep.classify(tokens)
    by_kernel = profile_device(lambda: dep.classify(tokens))
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
        "arbiter_energy_j": float(sum(r.energy_j for r in lane_reports)),
        "arbiter_deadline_met": int(sum(r.deadline_met for r in lane_reports)),
        "arbiter_latency_s_max": float(max(r.latency_s for r in lane_reports)),
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 6: the serving path
# ---------------------------------------------------------------------------


def host_split(srv, requests) -> dict:
    """Wall ms of one drain split by engine hook (host clock): ``lanes_step``
    holds the arbiter, the fused step's launches and the wait for the
    device (its outputs come back to the host every step); ``scheduler``
    is the rest, the lane scheduler's own Python."""
    import torch

    spent: dict = {}
    for name in ("lane_load", "lanes_step", "lane_advance", "lane_finish"):
        def timed(*a, _fn=getattr(srv, name), _name=name):
            t = time.perf_counter()
            out = _fn(*a)
            spent[_name] = spent.get(_name, 0.0) + (time.perf_counter() - t) * 1e3
            return out

        setattr(srv, name, timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(srv, requests)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return {"wall": wall, **spent, "scheduler": wall - sum(spent.values())}


def serving_setup(cfg, params, dev, n: int = 32, lanes: int = 8) -> dict:
    """The serving path's set-up: ``params`` on ``dev``, ``n`` seeded
    requests of 8-128 tokens, the exit threshold from a full-depth
    profiling drain, and ``fresh()``, which builds a ClassifierServer
    (``lanes`` lanes, BUCKETS) with a fresh shared-clock arbiter at the
    full-depth latency target."""
    import numpy as np

    from repro_torch.common.device import tree_to
    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.serving.dvfs import (
        BatchedDVFSArbiter,
        default_albert_controller,
        no_early_exit_baseline,
    )

    params = tree_to(params, dev)
    reqs = serving_requests(cfg, n, 128, seed=0)
    prof = drain(cfg, params, reqs, dev, buckets=BUCKETS, lanes=lanes, threshold=0.0)
    traces = np.asarray([prof.done[i].entropy_trace for i in range(n)], np.float64)
    thr = pick_threshold(traces)
    below = np.concatenate([traces[:, :-1] < thr, np.ones((n, 1), bool)], axis=1)
    profile_exits = np.argmax(below, axis=1) + 1
    target = no_early_exit_baseline(albert_layer_stats(seq_len=128))["latency_s"]

    def fresh():
        controller = default_albert_controller(
            target, seq_len=128, n_layers=cfg.n_layers,
            predictor=fit_exit_predictor(traces[:, 0], profile_exits, n_bins=8))
        return make_server(cfg, params, dev, buckets=BUCKETS, lanes=lanes, threshold=thr,
                           arbiter=BatchedDVFSArbiter(controller))

    return {"params": params, "requests": reqs, "threshold": thr, "profile_exits": profile_exits,
            "target": target, "fresh": fresh}


def run_serving_path(cfg, params, dev) -> dict:
    """Full-width ClassifierServer on the kernel route with a shared-clock
    arbiter: 32 seeded requests of 8-128 tokens, 8 lanes, buckets
    (32, 64, 128), threshold from a full-depth profiling drain.  Drain
    times are submit-to-drained, server set-up (block masks from the
    weights, a fresh arbiter) outside the clock."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    buckets, lanes, n = BUCKETS, 8, 32
    ctx = serving_setup(cfg, params, dev, n, lanes)
    reqs, thr, profile_exits = ctx["requests"], ctx["threshold"], ctx["profile_exits"]
    target, fresh = ctx["target"], ctx["fresh"]

    # the serving path, counted: one drain (server set-up outside the clock)
    srv = fresh()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    serve(srv, reqs)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()

    tel = srv.telemetry()
    exits = np.array([srv.done[i].exit_layer for i in range(n)])
    results = np.stack([srv.done[i].result for i in range(n)])
    if not (np.isfinite(results).all() and results.shape == (n, cfg.edgebert.early_exit.num_classes)):
        raise AssertionError("serving logits are not finite or of the wrong shape")
    if not np.array_equal(exits, profile_exits):
        raise AssertionError(f"serving exits {exits} differ from the profile's {profile_exits}")
    if tel["sentences"] != n or tel["step_traces"] > len(buckets):
        raise AssertionError(f"serving telemetry off: {tel}")
    missing = [k for k in ops.SERVING_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the serving path: {missing}")

    walls, setup = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        warm_srv = fresh()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        serve(warm_srv, reqs)
        torch.cuda.synchronize()
        setup.append((t1 - t0) * 1e3)
        walls.append((time.perf_counter() - t1) * 1e3)
    warm = float(np.median(walls))
    prof_srv = fresh()
    by_kernel = profile_device(lambda: serve(prof_srv, reqs))
    split = host_split(fresh(), reqs)
    busy = sum(g["ms"] for g in by_kernel.values())
    result = {
        "phase": "serving", "config": cfg.name, "span": False, "mlp_block_pruned": True,
        "n_layers": cfg.n_layers, "d_model": cfg.d_model, "requests": n, "lanes": lanes,
        "buckets": list(buckets), "lengths": [int(len(t)) for t in reqs], "threshold": thr,
        "exit_layers": [int(e) for e in exits], "avg_exit_layer": tel["avg_exit_layer"],
        "layer_calls": tel["layer_calls"], "fused_steps": tel["dense_steps"],
        "bucket_steps": tel["bucket_steps"], "lane_occupancy": tel["lane_occupancy"],
        "first_drain_ms": first_ms, "warm_drain_ms": walls, "warm_drain_ms_median": warm,
        "server_setup_ms": setup, "host_split_ms": split,
        "requests_per_s": n / (warm / 1e3),
        "device_busy_ms": busy, "device_idle_share": (1.0 - busy / warm) if busy > 0 else None,
        "device_ms_by_kernel": by_kernel, "launches": launches,
        "modeled_energy_j": tel["energy_j"], "op_switches": tel["op_switches"],
        "deadline_misses": tel["deadline_misses"], "modeled_latency_s_max": tel["modeled_latency_s"],
        "target_latency_s": target,
        "queue_delay_steps_p50": tel["queue_delay_steps_p50"],
        "queue_delay_steps_p95": tel["queue_delay_steps_p95"],
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
               if "registers" in ln or "spill" in ln or "smem" in ln][:8]
        for name in build.KERNELS
    }
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "resources": build.resources()})

    cfg = get_config("albert_edgebert")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    dep = deploy_albert(params, cfg, envm_cell="MLC2", seed=0, device=dev)
    emit({"phase": "deploy", "config": cfg.name, "seconds": time.perf_counter() - t0,
          "spans": [int(s) for s in dep.spans]})

    scfg = serving_config(cfg, span=False)
    sparams = serving_params(scfg, 0, prune=True)

    rows = check_kernels(dep, cfg, sparams, dev)
    check_reference(dep, params, cfg, dev)
    check_serving_reference(scfg, sparams, dev)
    main_path = run_main_path(dep, cfg, dev)
    serving = run_serving_path(scfg, sparams, dev)
    for r in rows:
        by_path = {"deploy": main_path["launches"][r["name"]], "serving": serving["launches"][r["name"]]}
        # a kernel's launches on this slice's path (serving), or on the
        # deployed path for the kernel only that path runs
        r["launches"] = by_path["serving"] if by_path["serving"] > 0 else by_path["deploy"]
        r["launches_by_path"] = by_path

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms", "launches_by_path")
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
