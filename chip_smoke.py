#!/usr/bin/env python3
"""Drive the PyTorch port of EdgeBERT on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line:
  1. device   — the card, as nvidia-smi reports its name and power limit;
  2. build    — compile all six CUDA kernels (one nvcc per source, all at
                once) and report each one's registers, spills and shared
                memory;
  3. kernel   — each kernel against its plain PyTorch version at its paths'
                shapes (the deployed batch, the serving phase's 8 lanes
                over buckets 32/64/128, the replay's 4 lanes over buckets
                16/32), with a stated tolerance, and its time beside the
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
                replaces (`replaced_device_ms`, `replaced_enqueue_us`), and
                softmax_entropy's wide-row entry at the decoders' [4 and 1,
                102400] and [4 and 1, 151936] logits beside the
                warp-per-row entry;
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
                counts, drain times and the device time by kernel;
  7. replay   — the multi-task path at the same width
                (launch/replay.py): a seeded 1000-event mmpp_multitask
                trace through per-task AdmissionControllers over a
                ResidencyRouter of four tasks with their own weights, one
                shared embedding and one arbiter; the replay kernels'
                launch counts, determinism on the card, the replay
                contract, replay wall time, device time by kernel and the
                host time by hook (1000 events, half the example's trace,
                for time); then the card against the CPU: quant_flips at
                the replay's lanes and buckets, the first 96 events at full
                depth (tasks, exits, summaries; logits and first entropies
                within 5e-2 as served, within 1e-4 with activation
                quantization off) and the whole smoke-size replay.
  8. decode   — the dense decoder at full width and depth (deepseek-7b:
                30 layers, d_model 4096, 32 x 128 heads, d_ff 11008, vocab
                102400, float32 weights drawn on the card from seed 0):
                probe_exit_threshold, then a DecoderServer drain of 8
                SyntheticLM requests (16-token prompts, 8 new tokens, 4
                lanes) with per-token exit and a shared-clock arbiter at
                spec window 1, and the same traffic at spec window 4;
                softmax_entropy's wide-row entry launched n_layers x W
                times per fused step, W = 4's tokens, exits and logits equal
                to W = 1's bit for bit, one decode and one prefill build per
                bucket; drain times, tokens/s, ms per fused step, device
                time by kernel and idle share, mean exit depth, accepted
                tokens per step, modeled energy per token, and the fused
                step and the prefill timed and profiled alone (device
                time by kernel, idle share) beside the fused step's HBM
                bound; then the card against the CPU on the first 2
                layers, teacher-forced (every off-ramp's logits and
                entropy within 1e-4).
 8b. moe_decode — the same recipe on the MoE decoder at full width and
                depth (qwen2-moe-a2.7b: 24 layers, d_model 2048, 16 x 128
                heads with qkv biases drawn nonzero, 60 experts of d_ff
                1408 top-4 and a shared expert of 5632, vocab 151936;
                57.3 GB of float32 weights drawn on the card after the
                decode phase's are released, the free memory checked and
                reported before and after the draw): softmax_entropy's
                wide-row entry launched 24 x W times per fused step, W = 4
                equal to W = 1 bit for bit, the step's bytes by part
                (experts, LM head, shared expert, attention) beside its
                HBM bound, and the first 2 layers against the CPU.
  9. train    — the Fig. 6 pipeline at albert_edgebert's published width
                (float32 weights from seed 0, SyntheticCLS seq 128, batch
                16): a teacher (make_train_step, pruning off), phase 1
                (magnitude pruning to 0.5 in 32x32 tiles, span learning,
                distillation from the teacher), phase 2 (the off-ramp
                alone), with no kernel launched by any training step; the
                first phase-1 steps on the card against the CPU from the
                same weights (losses, params, masks under the tie rule);
                the phase-2 loss falling; a checkpoint round trip, bit for
                bit; one phase-1 step timed and profiled alone; then the
                trained weights AF8-quantized, the embedding read back from
                the MLC2 eNVM, deployed (classify_with_dvfs) and served (a
                ClassifierServer drain with an arbiter), every kernel of
                ops.FINETUNE_KERNELS launched, span attention at the
                learned spans against its plain version; held-out accuracy,
                learned spans, sparsity, exit histograms and the DVFS
                operating points chosen.
Then each phase's seconds, the `{"kernels": [...]}` summary (one row per
kernel, at the replay's largest step shape with the replay's launches, or
for af_matmul, which only the deployed path runs, at the deployed layer
with that path's launches; softmax_entropy has two more rows, its wide-row
entry at the decode shape [4, 102400] with the decode phase's launches and
at the moe_decode shape [4, 151936] with that phase's),
the nvidia-smi line, and last
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
# the replay phase: the trace length (half the example's 2000: at 2000 the
# phase took 169 s of the script, over the time it may add), the prefix
# replayed on the card and on the CPU at full width, and the smoke-size
# replay's length
REPLAY_EVENTS = 1000
REPLAY_PREFIX = 96
SMOKE_REPLAY_EVENTS = 200
# the decode and moe_decode phases: deepseek-7b and qwen2-moe-a2.7b at
# full width and depth, 8 SyntheticLM requests of 16-token prompts and 8
# new tokens each in 4 lanes of one bucket (prompt + budget + 1 = 25 <=
# 32; 4 lanes is qwen2-moe's capacity C at 4 tokens, so its prefill steps
# a lane's row alone, exactly), per-token exit at the probe's median, spec
# window 4; the card against the CPU on the first 2 layers, teacher-forced,
# per-layer LM-head logits and entropies within 1e-4 (sums of up to 4096
# and 151936 terms in another order)
DECODE_LANES = 4
DECODE_REQUESTS = 8
DECODE_PROMPT = 16
DECODE_NEW = 8
DECODE_BUCKET = 32
DECODE_SPEC_WINDOW = 4
DECODE_REF_LAYERS = 2
DECODE_ATOL = 1e-4
# fused steps timed and profiled on their own (the drain's are too few and
# its profile too large)
DECODE_STEPS = 3
# card against CPU at full width: logits (and entropies) where activation
# quantization flips carry through twelve layers (see quant_flips), and the
# replay's per-request logits and first entropies without it
FULL_WIDTH_ATOL = 5e-2
REPLAY_ATOL = 1e-4

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

    from repro_torch.configs.base import get_config
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
    from repro_torch.launch import replay as rp
    from repro_torch.serving import deploy

    g = torch.Generator(device=dev).manual_seed(1)
    B, S, d, H, hd = 16, 128, cfg.d_model, cfg.n_heads, cfg.head_dim
    M = B * S
    rows = []
    # the fused step's shapes, (path, lanes, bucket): the serving phase's 8
    # lanes over BUCKETS and the replay's lanes over its buckets.  The
    # replay's largest bucket gives each serving kernel its summary row, so
    # the kernels line pairs the replay's launch counts with its own shapes.
    replay_buckets = tuple(int(b) for b in rp.MMPP_MULTITASK["buckets"])
    step_shapes = ([("serving", 8, S_b) for S_b in BUCKETS[::-1]]
                   + [("replay", rp.LANES, S_b) for S_b in replay_buckets[::-1]])

    def summary_of(path, S_b):
        return "replay" if (path, S_b) == ("replay", max(replay_buckets)) else None

    def row(name, source, replaces, shape, err, tol, ok, n_bytes, flops, *, ms, plain_ms, library_ms,
            device_ms, library_device_ms=None, summary=None, label, **detail):
        """Emit and check one kernel row.  A ``summary`` row (one per kernel)
        goes to the kernels line with the launches of that path ("replay" or
        "deploy"); the others check further shapes.  For the tensor-core
        kernels the row also gives the same work's time at the fp32 rate
        (``fp32_rate_ms``, not a bound for them)."""
        passes = TC_PASSES.get(name, 0)
        b_ms, b_by = bound_ms(n_bytes, flops, passes)
        r = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "shape": shape, "max_abs_err": err, "tolerance": tol, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
             "device_ms": device_ms, "library_device_ms": library_device_ms, "path": summary}
        if passes:
            detail["fp32_rate_ms"] = bound_ms(n_bytes, flops)[0]
        emit({"phase": "kernel", **r, "row": f"{name}@{label}", **detail})
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
                       lambda: F.layer_norm(x, (d,), gam, bet, eps=1e-6), enqueue=True),
        label="deployed")
    # ... and at the fused step's [lanes x S, 768] for each bucket S
    for path, ln_lanes, S_b in step_shapes:
        n_rows = ln_lanes * S_b
        xs_ = torch.randn(n_rows, d, generator=g, device=dev) * 3.0
        err = (layernorm(xs_, gam, bet) - ref.layernorm(xs_, gam, bet)).abs().max().item()
        row("layernorm", "src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/layernorm.py:17",
            f"{path}: [{n_rows}, {d}] fp32", err, "atol 1e-5", err <= 1e-5,
            (2 * n_rows * d + 2 * d) * 4, 8 * n_rows * d,
            **kernel_times(lambda: layernorm(xs_, gam, bet), lambda: ref.layernorm(xs_, gam, bet),
                           lambda: F.layer_norm(xs_, (d,), gam, bet, eps=1e-6), enqueue=True),
            summary=summary_of(path, S_b), label=f"{path}@S={S_b}")

    # softmax_entropy as the off-ramp head, one launch for pooler, classifier,
    # softmax entropy and retire: the fused step's [lanes, 768] on fp32
    # weights (serving: 8 lanes at S = 128; replay: its lanes at each of its
    # buckets, the summary row at the largest) and the deployed [16, 768] on
    # AF8 codes, the CLS rows read by stride from [lanes, S, 768] hidden
    # states.  Beside
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
    head_cases = ([("serving", 8, S, False), ("deployed", B, S, True)]
                  + [(f"replay@S={S_b}", rp.LANES, S_b, False) for S_b in replay_buckets[::-1]])
    for label, Bh, Sh, af in head_cases:
        hh = torch.randn(Bh, Sh, d, generator=g, device=dev)
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
            f"off-ramp head, {label}: h [{Bh}, {Sh}, {d}] by stride, pooler {d}x{d} + classifier {d}x{C} "
            f"{'AF8 codes' if af else 'fp32'}, packed [{Bh}, {C + 2}]", err,
            "atol 1e-5 (logits, entropy); retire equal 1e-4 from the threshold",
            err <= 1e-5 and retire_ok and chain_err <= 1e-5, n_bytes, flops,
            **kernel_times(lambda: offramp_head(hh, *args, active=act, threshold=thr, e_min=e_min),
                           lambda: ref.offramp_head(hh, *args, act, thr, e_min), enqueue=True),
            replaced_ms=time_ms(chain), replaced_device_ms=time_ms(chain, queued=True),
            replaced_enqueue_us=enqueue_us(chain), replaced_max_abs_err=chain_err,
            retire_equal=retire_ok, retire_compared=int(clear.sum()), launch_floor_device_ms=launch_floor,
            summary="replay" if label == f"replay@S={max(replay_buckets)}" else None, label=label)

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
            **kernel_times(lambda: softmax_entropy(lg), lambda: ref.softmax_entropy(lg)),
            label=f"logits[{rows_}]")

    # ... and the wide-row entry, the decode path's LM-head entropy
    # (dispatch.entropy) at the decoders' [lanes, vocab] fp32 logits:
    # deepseek-7b's vocabulary (102400) and qwen2-moe's (151936), each at 4
    # lanes (a summary row, with the decode or moe_decode phase's launches)
    # and one lane; entropy within 1e-5 of the plain version (the
    # determinism phase launches it twice at these shapes for the same
    # bits).  Beside it the warp-per-row
    # entry on the same logits (`replaced_device_ms`: probs and entropy,
    # what this entry replaced on the decode path) and an empty launch.
    # Bound: one read of the logits.
    from repro_torch.kernels.softmax_entropy import entropy as entropy_rows

    for path, arch in (("decode", "deepseek_7b"), ("moe_decode", "qwen2_moe_a2p7b")):
        vocab = get_config(arch).vocab_size
        for rows_ in (DECODE_LANES, 1):
            lg = torch.randn(rows_, vocab, generator=g, device=dev) * 1.28
            err = (entropy_rows(lg) - ref.softmax_entropy(lg)[1]).abs().max().item()
            row("softmax_entropy", "src/repro_torch/csrc/softmax_entropy.cu",
                "src/repro/kernels/softmax_entropy.py:17",
                f"{path} LM-head entropy (wide-row entry): logits [{rows_}, {vocab}] fp32", err,
                "atol 1e-5 (entropy)", err <= 1e-5, (rows_ * vocab + rows_) * 4, 8.0 * rows_ * vocab,
                **kernel_times(lambda: entropy_rows(lg), lambda: ref.softmax_entropy(lg), enqueue=True),
                replaced_ms=time_ms(lambda: softmax_entropy(lg)),
                replaced_device_ms=time_ms(lambda: softmax_entropy(lg), queued=True),
                launch_floor_device_ms=launch_floor,
                summary=path if rows_ == DECODE_LANES else None, label=f"{path}[{rows_}]")

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
            device_ms=dev_ms, library_device_ms=lib_dev, summary="deploy" if label == "layer" else None,
            label=label, per_shape=per_shape)

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
                       enqueue=True),
        label="deployed")

    # the fused step: window = S, no spans, one kv_len per lane, lanes x 12
    # heads; the keys at or past a lane's kv_len are neither read nor needed
    for path, lanes, Sb in step_shapes:
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
            f"{path}: B={lanes}, S={Sb}, H={H}, dh={hd}, window={Sb}, kv_lens in [1, {Sb}], "
            "[B, S, H, dh] views", err, "atol 2e-5", err <= 2e-5,
            (2 * lanes * H * Sb * hd + 2 * hd * key_rows) * 4 + lanes * 4, 4.0 * hd * Sb * key_rows,
            **kernel_times(lambda: heads_call(qs, ks, vs, None, Sb, lens),
                           lambda: ref.span_attention(heads(qs), heads(ks), heads(vs), full_d,
                                                      causal=False, kv_lens=lens[:, None].expand(-1, H)),
                           lambda: F.scaled_dot_product_attention(heads(qs), heads(ks), heads(vs),
                                                                  attn_mask=kmask),
                           enqueue=True),
            summary=summary_of(path, Sb), label=f"{path}@S={Sb}")

    # af_quantize through quantize_groups, the serving path's one launch
    # (amax, bias and quantize): the fused step's [lanes x S, 768]
    # activations at each path's buckets S, one bias per lane (one lane
    # scaled down, the tail of another up); at S = 128 also every
    # float32 within 64 ulp of 2**k, k in [-20, 20], through the same
    # launch (one group per k) and through `quantize` with the biases
    # given; atol 0 and equal biases against the plain version run on the
    # CPU (group_exp_bias + ref.quantize).  Beside it the chain it replaces
    # (`replaced_*`): group_exp_bias's PyTorch ops, then `quantize`; and a
    # PyTorch copy of the same tensor (`copy_device_ms`: one read and one
    # write, what the bound counts).
    edges, rpg = binade_edges()
    xe = torch.from_numpy(edges)
    e_edges = group_exp_bias(xe, rpg)
    for path, lanes, S_b in step_shapes:
        xa = torch.randn(lanes * S_b, d, generator=g, device=dev) * 2.0
        tiny, hot = 3 * lanes // 8, 5 * lanes // 8
        xa[tiny * S_b:(tiny + 1) * S_b] *= 1e-3
        xa[(hot + 1) * S_b - S_b // 4:(hot + 1) * S_b] *= 50.0
        e_cpu = group_exp_bias(xa.cpu(), S_b)
        q, e_min = quantize_groups(xa, S_b)
        err = (q.cpu() - ref.quantize(xa.cpu(), e_cpu, S_b)).abs().max().item()
        ok = torch.equal(e_min.cpu(), e_cpu)
        shape = f"{path}: [{lanes * S_b}, {d}] fp32, {lanes} row groups of {S_b}"
        if (path, S_b) == ("serving", BUCKETS[-1]):
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
            summary=summary_of(path, S_b), label=f"{path}@S={S_b}")

    # block_sparse_matmul: the pruned MLP weights at M = lanes x S for each
    # path's buckets S
    # the weights on the card, and their indices with the tiles packed from
    # them (the kernel takes an index only with the weight it was packed from)
    mlp = {k: v.to(dev).float().contiguous() for k, v in sparams["layer"]["mlp"].items()}
    masks = dispatch.mlp_block_masks(mlp)
    for path, lanes, S_b in step_shapes:
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
            f"{path}: M={Mb}: {' + '.join(shapes)} at 32x32 tiles (times and bound summed; bound on "
            "occupied tiles)", err, "rtol 1e-5 + atol 1e-5", ok, n_bytes, flops, ms=ms, plain_ms=plain,
            library_ms=lib, device_ms=dev_ms, library_device_ms=lib_dev, summary=summary_of(path, S_b),
            label=f"{path}@S={S_b}", per_shape=per_shape)

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
    for Mx in (1024, 512, 256, 128, 64):
        for name in ("w_up", "w_down"):
            w = mlp[name]
            xk = torch.randn(Mx, w.shape[0], generator=g, device=dev)
            same(f"block_sparse_matmul M={Mx} {name}", lambda: block_sparse_matmul(xk, w, masks[name]))
    x = torch.randn(2048, 768, generator=g, device=dev)
    gam, bet = torch.randn(768, generator=g, device=dev), torch.randn(768, generator=g, device=dev)
    same("layernorm", lambda: layernorm(x, gam, bet))
    lg = torch.randn(16, 3, generator=g, device=dev)
    same("softmax_entropy", lambda: softmax_entropy(lg))
    # the wide-row entry: triples merged in a fixed tree across a cluster
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.softmax_entropy import entropy as entropy_rows

    for arch in ("deepseek_7b", "qwen2_moe_a2p7b"):
        for rows_ in (DECODE_LANES, 1):
            lgv = torch.randn(rows_, get_config(arch).vocab_size, generator=g, device=dev)
            same(f"softmax_entropy wide rows [{rows_}, {lgv.shape[1]}]", lambda: entropy_rows(lgv))
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
    for lanes, S_b in [(8, S_b) for S_b in BUCKETS] + [(4, 16), (4, 32)]:
        same(f"af_quantize {lanes} groups of {S_b} rows",
             lambda: quantize_groups(x[:lanes * S_b].contiguous(), S_b))
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


def serve(srv, requests, **request_kw):
    """Submit ``requests`` (with ``request_kw`` on each, e.g. the decoder's
    ``max_new_tokens``) and drain them; returns the server."""
    from repro_torch.serving.engine import Request

    for i, t in enumerate(requests):
        srv.submit(Request(uid=i, tokens=t, **request_kw))
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
                  serving_requests(cfg_full, 8, 128, seed=2), BUCKETS, 8, FULL_WIDTH_ATOL, False))
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
    "entropy_rows_kernel": "softmax_entropy",
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


def host_split(srv, requests, sync: bool = False, **request_kw) -> dict:
    """Wall ms of one drain split by engine hook (host clock): ``lanes_step``
    holds the arbiter, the fused step's launches and the wait for the
    device (its outputs come back to the host every step); ``scheduler``
    is the rest, the lane scheduler's own Python.  With ``sync`` each hook
    waits for the device before its time is taken (the decoder's prefill
    in ``lane_load`` returns before its work is done)."""
    import torch

    spent: dict = {}
    for name in ("lane_load", "lanes_step", "lane_advance", "lane_finish"):
        def timed(*a, _fn=getattr(srv, name), _name=name):
            t = time.perf_counter()
            out = _fn(*a)
            if sync:
                torch.cuda.synchronize()
            spent[_name] = spent.get(_name, 0.0) + (time.perf_counter() - t) * 1e3
            return out

        setattr(srv, name, timed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(srv, requests, **request_kw)
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


# ---------------------------------------------------------------------------
# phase 7: the multi-task trace replay
# ---------------------------------------------------------------------------


def replay_target(stack, dev, *, threshold=None, act_quant=True):
    """A fresh replay target of the stack (``launch/replay.py``'s
    ``build_stack``) on ``dev``, recording each request (its set-up: params
    moved, block indices and packed tiles built per task server);
    ``threshold`` overrides the exit threshold, ``act_quant=False`` turns
    activation quantization off."""
    import dataclasses

    from repro_torch.launch import replay as rp

    cfg = stack.cfg
    if threshold is not None:
        cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit,
                                                               entropy_threshold=threshold))
    if not act_quant:
        cfg = cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, quantize_activations=False))
    return rp.build_target(cfg, stack.embed, stack.by_task, stack.ctrl_factory, device=dev,
                           target_cls=rp.RecordingRouterTarget)


def run_replay(stack, dev, n: int, *, target=None, **target_kw):
    """One replay of the stack's first ``n`` events on ``target`` (a fresh
    one from ``replay_target(stack, dev, **target_kw)`` by default), set-up
    outside the clock; returns (summary, target, wall ms)."""
    import torch

    from repro_torch.serving.workload import TraceReplayer, generate_trace

    target = replay_target(stack, dev, **target_kw) if target is None else target
    events = generate_trace(stack.wl, n, service_s=stack.svc)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = TraceReplayer(target, vocab_size=stack.cfg.vocab_size, token_seed=0).replay(events)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return summary, target, (time.perf_counter() - t0) * 1e3


def compare_replays(name, stack, card, cpu, seconds: float, *, atol=None, **detail) -> dict:
    """The card's replay against the CPU's: every request served by the same
    task with the same exit layer, and summaries_identical; with ``atol``
    also every request's logits and first off-ramp entropy within ``atol``.
    On a mismatch the first differing request is printed with its first
    off-ramp entropy and LUT bin on both sides."""
    import numpy as np

    from repro_torch.serving.workload import summaries_identical

    (s_card, t_card, _), (s_cpu, t_cpu, _) = card, cpu
    same_summary = summaries_identical(s_card, s_cpu)
    diff = sorted(u for u in set(t_card.record) | set(t_cpu.record)
                  if t_card.record.get(u) != t_cpu.record.get(u))
    both = sorted(set(t_card.logits) & set(t_cpu.logits))
    lg_err = [float(np.abs(t_card.logits[u] - t_cpu.logits[u]).max()) for u in both]
    ent_err = [abs(t_card.first_entropy[u] - t_cpu.first_entropy[u]) for u in both]
    close = atol is None or max(lg_err + ent_err, default=0.0) <= atol
    r = {"phase": "replay_reference", "config": name, "requests": s_card["requests"],
         "completed": s_card["completed"], "records_equal": not diff,
         "summaries_identical": same_summary,
         "accepted_slo_misses": [s_card["accepted_slo_misses"], s_cpu["accepted_slo_misses"]],
         "exit_layers": sorted({e for _, e in t_card.record.values()}),
         "logits_max_abs_err": max(lg_err, default=0.0),
         "first_entropy_max_abs_err": max(ent_err, default=0.0),
         "requests_beyond_1e-4": sum(max(a, b) > 1e-4 for a, b in zip(lg_err, ent_err)),
         "tolerance": atol, "seconds": seconds, **detail}
    if diff:
        u = diff[0]
        edges = stack.ctrl_factory().predictor.bin_edges
        ents = [t.first_entropy.get(u) for t in (t_card, t_cpu)]
        r["first_difference"] = {
            "uid": u, "card": t_card.record.get(u), "cpu": t_cpu.record.get(u),
            "first_entropy": ents,
            "lut_bin": [None if e is None else int(np.searchsorted(edges, e, side="right")) for e in ents]}
    if not same_summary:
        r["summary_differences"] = {k: [s_card[k], s_cpu.get(k)] for k in s_card
                                    if s_card[k] != s_cpu.get(k)}
    emit(r)
    if diff or not same_summary or not close:
        raise AssertionError(f"the card's replay and the CPU's disagree on {name}")
    return r


def replay_host_split(stack, dev, n: int) -> dict:
    """Host ms of one replay split by hook: the router's task choice
    (candidate snapshots and the affinity policy), admission quotes, the
    router target's displacement guard, each task server's fused step
    (``lanes_step``: arbiter, launches, the step's one copy back) and lane
    loads (embed, residency, admit); ``other`` is the rest (the lane
    scheduler, the replayer's loop, submits and polls)."""
    spent: dict = {}

    def wrap(obj, attr, key):
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] = spent.get(key, 0.0) + (time.perf_counter() - t) * 1e3

        setattr(obj, attr, timed)

    target = replay_target(stack, dev)
    router = target.router
    wrap(router, "_task_views", "router_choice")
    wrap(router.task_policy, "choose_task", "router_choice")
    wrap(target, "_admitting_displaces", "displacement_guard")
    for ac in target.admission.values():
        wrap(ac, "quote", "admission_quote")
    for srv in router.tasks.values():
        wrap(srv, "lanes_step", "lanes_step")
        wrap(srv, "lane_load", "lane_load")
    _, _, wall = run_replay(stack, dev, n, target=target)
    return {"wall": wall, **spent, "other": wall - sum(spent.values())}


def run_replay_path(scfg, dev) -> dict:
    """Full-width replay (the serving phase's configuration, four tasks with
    their own params from seeds 10-13, task 0's embedding shared) on the
    kernel route, and its checks against the CPU."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import replay as rp
    from repro_torch.serving.workload import summaries_identical

    seconds, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        seconds[name] = time.perf_counter() - t
        t = time.perf_counter()

    tasks = [name for name, _ in rp.MMPP_MULTITASK["tasks"]]
    stack = rp.build_stack(scfg, tasks, prune=True)
    lap("setup")
    # the replay path, counted: one replay (target set-up outside the clock)
    ops.reset_launch_counts()
    first = run_replay(stack, dev, REPLAY_EVENTS)
    launches = ops.launch_counts()
    summary, target, first_ms = first
    missing = [k for k in ops.REPLAY_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the replay path: {missing}")
    steps = rp.fused_steps(target)
    # determinism on the card: three more same-seed replays on fresh stacks
    # (timed: the warm replays)
    lap("counted")
    warm = [run_replay(stack, dev, REPLAY_EVENTS) for _ in range(3)]
    lap("warm")
    identical = all(summaries_identical(summary, w[0]) and w[1].record == target.record for w in warm)
    walls = [w[2] for w in warm]
    wall = float(np.median(walls))
    conserved = summary["completed"] + summary["rejected"] + summary["shed"] == summary["submitted"]
    contract = {"conserved": conserved,
                "max_traces_per_bucket_replica": summary["max_traces_per_bucket_replica"],
                "accepted_slo_misses": summary["accepted_slo_misses"]}
    prof_target = replay_target(stack, dev)
    by_kernel = profile_device(lambda: run_replay(stack, dev, REPLAY_EVENTS, target=prof_target))
    lap("profile")
    busy = sum(g["ms"] for g in by_kernel.values())
    split = replay_host_split(stack, dev, REPLAY_EVENTS)
    lap("host_split")
    result = {
        "phase": "replay", "config": scfg.name, "span": False, "mlp_block_pruned": True,
        "n_layers": scfg.n_layers, "d_model": scfg.d_model, "tasks": tasks,
        "events": REPLAY_EVENTS, "lanes": rp.LANES, "buckets": rp.MMPP_MULTITASK["buckets"],
        "threshold": stack.cfg.edgebert.early_exit.entropy_threshold,
        "summary": summary, "contract": contract, "deterministic": identical,
        "exit_layer_counts": {int(e): int(c) for e, c in zip(*np.unique(
            [e for _, e in target.record.values()], return_counts=True))},
        "launches": launches, "fused_steps": steps,
        "task_swaps": summary["task_swaps"], "task_switches": target.router.task_switches,
        "first_replay_ms": first_ms, "warm_replay_ms": walls, "warm_replay_ms_median": wall,
        "requests_per_s": summary["completed"] / (wall / 1e3),
        "device_busy_ms": busy, "device_idle_share": (1.0 - busy / wall) if busy > 0 else None,
        "device_ms_by_kernel": by_kernel, "host_split_ms": split, "seconds": seconds,
    }
    emit(result)
    if not identical:
        raise AssertionError("same-seed replays on the card diverged")
    if not (conserved and contract["max_traces_per_bucket_replica"] <= 1):
        raise AssertionError(f"the replay contract does not hold: {contract}")

    # the card against the CPU: the first events at full width and full
    # depth (no exit decision can flip; first-layer entropies still pick
    # the LUT bin), with activation quantization as served and without it,
    # and the whole smoke-size replay of launch/replay.py.  As served, an
    # element whose float32 sums straddle an AF rounding boundary flips one
    # grid step and twelve layers carry it to the logits: they are held to
    # the full-width serving check's FULL_WIDTH_ATOL, resting on
    # quant_flips at the replay's lanes and buckets (task 0's weights),
    # which holds the layer step before quantization to PRE_QUANT_ATOL and
    # every flip to one step at a boundary.  Without quantization nothing
    # can flip: logits and first entropies within REPLAY_ATOL.
    cpu = torch.device("cpu")
    lanes, buckets = rp.LANES, tuple(int(b) for b in rp.MMPP_MULTITASK["buckets"])
    flips = [quant_flips(stack.cfg, stack.by_task[tasks[0]],
                         [x[:S_b] for x in serving_requests(stack.cfg, lanes, S_b, seed=3)], dev, S_b)
             for S_b in buckets]
    prefix = [run_replay(stack, d, REPLAY_PREFIX, threshold=0.0) for d in (dev, cpu)]
    full = compare_replays("full_depth_prefix", stack, *prefix, seconds=time.perf_counter() - t,
                           atol=FULL_WIDTH_ATOL, quant_flips=flips)
    t = time.perf_counter()
    compare_replays("full_depth_prefix_no_act_quant", stack,
                    *[run_replay(stack, d, REPLAY_PREFIX, threshold=0.0, act_quant=False) for d in (dev, cpu)],
                    seconds=time.perf_counter() - t, atol=REPLAY_ATOL)
    t = time.perf_counter()
    smoke = rp.build_stack(rp.replay_config(smoke=True), tasks)
    compare_replays("smoke", smoke, *[run_replay(smoke, d, SMOKE_REPLAY_EVENTS) for d in (dev, cpu)],
                    seconds=time.perf_counter() - t)
    if full["accepted_slo_misses"][0] != full["accepted_slo_misses"][1]:
        raise AssertionError("accepted-SLO misses differ between the card and the CPU")
    return result


# ---------------------------------------------------------------------------
# phase 8: the decoders at full width and depth (deepseek-7b, the dense
# family; qwen2-moe-a2.7b, the MoE family)
# ---------------------------------------------------------------------------


def leaves(tree) -> list:
    """The tensors of a nested dict."""
    return [x for v in tree.values() for x in (leaves(v) if isinstance(v, dict) else [v])]


def n_bytes(tree) -> int:
    """The bytes of a tensor or of the tensors of a nested dict."""
    return sum(t.numel() * t.element_size() for t in (leaves(tree) if isinstance(tree, dict) else [tree]))


def cut_layers(tree, n: int) -> dict:
    """Views of the first ``n`` of the stacked layers, at every depth of the
    tree (the MoE layer nests its shared expert)."""
    return {k: cut_layers(v, n) if isinstance(v, dict) else v[:n] for k, v in tree.items()}


def check_decode_reference(cfg, params, prompts, thr, dev) -> dict:
    """The card against the CPU on the decoder's first DECODE_REF_LAYERS
    layers (views of the card's weights; their copy on the CPU runs the
    plain versions): one lane, teacher-forced through a prompt and a fixed
    continuation (no argmax near-tie can fork the sequences), each token one
    ``decode_step_ee`` at the decode phase's threshold.  Every LM-head
    off-ramp the steps evaluate (``_head_entropy``, recorded per layer)
    must agree within DECODE_ATOL in logits and entropy, the returned
    logits and first entropies too; exit layers must be equal where no
    entropy lies within DECODE_ATOL of the threshold (those tokens are
    counted as excused; after a token whose exits differ the caches part,
    and the comparison stops there)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    cfg_r = dataclasses.replace(cfg, n_layers=DECODE_REF_LAYERS)
    cut = dict(params, layers=cut_layers(params["layers"], DECODE_REF_LAYERS))
    seq = [int(t) for t in prompts[0]] + [int(t) for t in prompts[1][:DECODE_NEW]]
    cpu = torch.device("cpu")

    def run(p, d):
        model = build_model(cfg_r)
        heads = model._head_entropy
        rec: list = []

        def recording(p_, h, use_kernels=False):
            lg, ent = heads(p_, h, use_kernels)
            rec.append((lg[0, 0].cpu(), float(ent[0, 0])))
            return lg, ent

        model._head_entropy = recording
        cache = model.init_cache(1, DECODE_BUCKET, device=d)
        steps = []
        with torch.no_grad():
            for t, tok in enumerate(seq):
                lg, cache, xl, fe = model.decode_step_ee(p, cache, torch.tensor([[tok]], device=d), t, thr,
                                                         use_kernels=True)
                steps.append((lg[0, 0].cpu(), int(xl[0]), float(fe[0])))
        return rec, steps

    t0 = time.perf_counter()
    rec_card, card = run(cut, dev)
    p_cpu = tree_to(cut, cpu)
    rec_cpu, host = run(p_cpu, cpu)
    L_ = DECODE_REF_LAYERS
    logit_err = ent_err = out_err = fe_err = 0.0
    excused, compared, diverged_at = 0, 0, None
    for t in range(len(seq)):
        for i in range(L_):
            (lg_a, e_a), (lg_b, e_b) = rec_card[t * L_ + i], rec_cpu[t * L_ + i]
            logit_err = max(logit_err, (lg_a - lg_b).abs().max().item())
            ent_err = max(ent_err, abs(e_a - e_b))
        (o_a, x_a, f_a), (o_b, x_b, f_b) = card[t], host[t]
        near = any(abs(e - thr) < DECODE_ATOL for _, e in rec_card[t * L_:(t + 1) * L_])
        excused += int(near)
        compared += 1
        if x_a != x_b:
            if not near:
                raise AssertionError(f"decode reference: token {t} exits at {x_a} on the card, {x_b} on the CPU, "
                                     f"no entropy within {DECODE_ATOL} of the threshold")
            diverged_at = t
            break
        out_err = max(out_err, (o_a - o_b).abs().max().item())
        fe_err = max(fe_err, abs(f_a - f_b))
    result = {"phase": "reference", "config": f"{cfg.name} first {L_} layers (cut from {cfg.n_layers})",
              "teacher_forced_tokens": len(seq), "compared_tokens": compared, "threshold": thr,
              "tolerance": f"atol {DECODE_ATOL} (logits and entropies of every off-ramp)",
              "offramp_logits_max_abs_err": logit_err, "offramp_entropy_max_abs_err": ent_err,
              "step_logits_max_abs_err": out_err, "first_entropy_max_abs_err": fe_err,
              "exit_layers_card": [x for _, x, _ in card], "exit_layers_cpu": [x for _, x, _ in host],
              "boundary_tokens_excused": excused, "diverged_at": diverged_at,
              "seconds": time.perf_counter() - t0}
    emit(result)
    if max(logit_err, ent_err, out_err, fe_err) > DECODE_ATOL:
        raise AssertionError(f"decode reference: card and CPU differ beyond {DECODE_ATOL}")
    return result


def run_decode_path(dev, arch: str = "deepseek_7b") -> dict:
    """A decoder at full width and depth, float32 weights drawn on the card
    from seed 0, through the DecoderServer: deepseek-7b (the ``decode``
    phase: 30 layers, d_model 4096, 32 x 128 heads, d_ff 11008, vocab
    102400) or qwen2-moe-a2.7b (``moe_decode``: 24 layers, d_model 2048,
    16 x 128 heads, 60 experts of d_ff 1408 top-4 and a shared expert of
    5632, qkv biases drawn nonzero from the same generator, vocab 151936;
    the free device memory is checked before the draw).  The recipe of the
    JAX package's examples/serve_multitask.py decoder lane:
    probe_exit_threshold (median of first-off-ramp entropies at full
    depth), then a drain with per-token exit and a shared-clock arbiter at
    spec_window 1, then the same traffic at spec_window 4 with an
    ExitThresholdSchedule.  Checks the kernels' launches (softmax_entropy
    n_layers x W per fused step, every kernel of the family's list), W =
    4's accepted tokens, exit depths and final logits equal to W = 1's bit
    for bit, one decode and one prefill build per bucket; then times,
    device time by kernel, the fused step's bytes and HBM bound, and the
    card against the CPU on the first two layers."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.early_exit import ExitThresholdSchedule
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController, no_early_exit_baseline
    from repro_torch.serving import step_math
    from repro_torch.serving.engine import DecoderServer, probe_exit_threshold

    cfg = dataclasses.replace(get_config(arch), dtype="float32", remat_policy="none")
    phase = "moe_decode" if cfg.family == "moe" else "decode"
    kernels = ops.MOE_DECODE_KERNELS if cfg.family == "moe" else ops.DECODE_KERNELS
    model = build_model(cfg)
    # the previous phase's weights go back to the card first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    free_before = torch.cuda.mem_get_info()[0]
    need = cfg.num_params() * 4
    if free_before < need:
        raise AssertionError(f"{phase}: {free_before / 1e9:.2f} GB free on the card, the weights need "
                             f"{need / 1e9:.2f} GB")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    if cfg.qkv_bias:                    # the init zeroes them, as the JAX package's does
        for name in ("bq", "bk", "bv"):
            params["layers"]["attn"][name].normal_(generator=gen).mul_(0.5)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    free_after = torch.cuda.mem_get_info()[0]
    n_params = sum(t.numel() for t in leaves(params))
    emit({"phase": f"{phase}_weights", "config": cfg.name, "params": n_params, "bytes": n_bytes(params),
          "mem_free_gb_before_draw": free_before / 1e9, "mem_free_gb_after_draw": free_after / 1e9,
          "init_s": init_s})
    prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    n, W4 = DECODE_REQUESTS, DECODE_SPEC_WINDOW

    t0 = time.perf_counter()
    thr = probe_exit_threshold(model, params, prompts, batch_lanes=DECODE_LANES, max_seq=DECODE_BUCKET,
                               buckets=(DECODE_BUCKET,), max_new_tokens=DECODE_NEW, device=dev)
    probe_s = time.perf_counter() - t0
    stats = albert_layer_stats(seq_len=DECODE_BUCKET)
    stats.n_layers = cfg.n_layers
    target = no_early_exit_baseline(stats)["latency_s"] * 2.0

    def fresh(W):
        arb = BatchedDVFSArbiter(LatencyAwareDVFSController(stats, target))
        return DecoderServer(model, params, batch_lanes=DECODE_LANES, max_seq=DECODE_BUCKET, eos_id=-1,
                             buckets=(DECODE_BUCKET,), arbiter=arb, exit_threshold=thr, spec_window=W,
                             threshold_schedule=ExitThresholdSchedule(thr) if W > 1 else None, device=dev)

    drains, servers = {}, {}
    for W in (1, W4):
        srv = fresh(W)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        serve(srv, prompts, max_new_tokens=DECODE_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        tel = srv.telemetry()
        steps = tel["decode_steps"]
        want = cfg.n_layers * W * steps
        if launches["softmax_entropy"] != want or any(launches[k] <= 0 for k in kernels):
            raise AssertionError(f"{phase} W={W}: softmax_entropy launched {launches['softmax_entropy']} times, "
                                 f"want n_layers x W x fused steps = {want}")
        if tel["decode_traces_per_bucket"] != {DECODE_BUCKET: 1} or tel["prefill_traces"] != 1:
            raise AssertionError(f"{phase} W={W}: builds per bucket: {tel}")
        results = np.stack([srv.done[i].result for i in range(n)])
        gen_toks = [srv.done[i].generated for i in range(n)]
        exits = [srv.done[i].token_exit_layers for i in range(n)]
        if not (np.isfinite(results).all() and results.shape == (n, cfg.vocab_size)):
            raise AssertionError(f"{phase} W={W}: decode logits are not finite or of the wrong shape")
        if any(len(g_) != DECODE_NEW or not all(0 <= t < cfg.vocab_size for t in g_) for g_ in gen_toks):
            raise AssertionError(f"{phase} W={W}: generated tokens off: {gen_toks}")
        if not all(1 <= x <= cfg.n_layers for e in exits for x in e):
            raise AssertionError(f"{phase} W={W}: exit layers out of range: {exits}")
        servers[W] = srv
        drains[W] = {
            "spec_window": W, "drain_ms": wall, "tokens": tel["tokens"],
            "tokens_per_s": tel["tokens"] / (wall / 1e3), "fused_steps": steps,
            "ms_per_fused_step": None, "launches": launches,
            "softmax_entropy_launches_per_fused_step": launches["softmax_entropy"] / steps,
            "avg_token_exit_layer": tel["avg_token_exit_layer"],
            "tokens_per_fused_step": tel["tokens_per_fused_step"],
            "avg_accepted_block": tel["avg_accepted_block"],
            "modeled_energy_j": tel["energy_j"], "modeled_energy_per_token_j": tel["energy_j"] / tel["tokens"],
            "deadline_misses": tel["deadline_misses"], "op_switches": tel["op_switches"],
            "generated": gen_toks, "token_exit_layers": exits,
        }
    a, b = servers[1], servers[W4]
    for i in range(n):
        if (a.done[i].generated != b.done[i].generated
                or a.done[i].token_exit_layers != b.done[i].token_exit_layers
                or not np.array_equal(a.done[i].result, b.done[i].result)):
            raise AssertionError(f"{phase} request {i}: spec_window {W4} differs from spec_window 1")

    # where one drain's time goes: the prefill (lane loads) and the fused
    # steps, each waited for on the device
    for W in (1, W4):
        split = host_split(fresh(W), prompts, sync=True, max_new_tokens=DECODE_NEW)
        drains[W]["host_split_ms"] = split
        drains[W]["ms_per_fused_step"] = split["lanes_step"] / drains[W]["fused_steps"]
    # the device's share of the two parts, each timed alone (host clock,
    # synchronised) and profiled (device time by kernel: cuBLAS GEMVs, RMS
    # norms, the reference cache attention and, for the MoE family, the
    # routing and expert products under "other"): DECODE_STEPS fused W = 1
    # steps of the 4 lanes at mid-bucket positions, and one request's
    # prefill (15 one-token full-depth steps); a profile of a whole drain
    # holds ~400k events and takes minutes to read
    cache = model.init_cache(DECODE_LANES, DECODE_BUCKET, device=dev)
    cur = torch.as_tensor(np.asarray(prompts[:DECODE_LANES, -1:], np.int64), device=dev)
    pos = torch.full((DECODE_LANES,), DECODE_PROMPT - 1, dtype=torch.int64, device=dev)

    def fused_steps():
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                step_math.decoder_decode_ee(model, params, cache, cur, pos, thr, use_kernels=True)

    def prefill():
        with torch.no_grad():
            step_math.decoder_prefill(model, params, cache, prompts[0], 0, DECODE_PROMPT, use_kernels=True)

    parts = {}
    for name, fn, count in (("fused_step", fused_steps, DECODE_STEPS), ("prefill", prefill, 1)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / count
        by_kernel = profile_device(fn)
        busy = sum(g_["ms"] for g_ in by_kernel.values()) / count
        parts[name] = {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                       "device_ms_by_kernel": by_kernel, "per": count}
    # the fused step's least time: its bytes at the HBM rate (every layer's
    # weights, all experts' too, since each layer runs every expert's
    # capacity buffer as the JAX package does; the LM head once per layer;
    # the cache read per layer)
    layers = params["layers"]
    step_bytes = {"attention_and_norms": n_bytes(layers["attn"]) + n_bytes(layers["norm1"])
                  + n_bytes(layers["norm2"])}
    if "moe" in layers:
        moe_p = layers["moe"]
        step_bytes["experts"] = sum(n_bytes(moe_p[k]) for k in ("w_gate", "w_up", "w_down"))
        step_bytes["router"] = n_bytes(moe_p["router"])
        if "shared" in moe_p:
            step_bytes["shared_expert"] = n_bytes(moe_p["shared"])
    else:
        step_bytes["mlp"] = n_bytes(layers["mlp"])
    step_bytes["lm_head_per_layer"] = cfg.n_layers * n_bytes(params["lm_head"])
    step_bytes["kv_cache"] = n_bytes(cache)
    step_bound_ms = sum(step_bytes.values()) / HBM_BYTES_PER_S * 1e3
    ref = check_decode_reference(cfg, params, prompts, thr, dev)
    result = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff,
        "shared_expert_d_ff": cfg.shared_expert_d_ff, "qkv_bias": cfg.qkv_bias,
        "dtype": cfg.dtype, "params": n_params, "init_s": init_s,
        "mem_free_gb_before_draw": free_before / 1e9, "mem_free_gb_after_draw": free_after / 1e9,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "requests": n, "prompt_tokens": DECODE_PROMPT, "max_new_tokens": DECODE_NEW, "lanes": DECODE_LANES,
        "bucket": DECODE_BUCKET, "threshold": thr, "probe_s": probe_s,
        "target_latency_s": target, "drains": {f"W={W}": d for W, d in drains.items()},
        "spec_equals_per_token": True, "parts": parts,
        "fused_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()},
        "fused_step_hbm_bound_ms": step_bound_ms, "launches": drains[1]["launches"],
        "reference": {k: ref[k] for k in ("offramp_logits_max_abs_err", "offramp_entropy_max_abs_err",
                                           "boundary_tokens_excused", "compared_tokens")},
    }
    emit(result)
    del params, servers, a, b, srv, cache, layers
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 9: training (the Fig. 6 pipeline) and the trained weights deployed
# ---------------------------------------------------------------------------

# albert_edgebert at its published width, float32, SyntheticCLS (seq 128,
# batch 16, seed 0): a teacher trained without pruning, phase 1 (magnitude
# pruning to 0.5 in 32x32 tiles, span learning, distillation from the
# teacher), phase 2 (the off-ramp alone); then the card against the CPU on
# the first phase-1 steps from the same weights.  The sentences draw their
# token ids below TRAIN_DATA_VOCAB (the smoke config's vocabulary): over all
# 30000 ids each class band holds 2,499 ids, each seen about 4 times in the
# phase's 100 steps, and random embeddings share nothing within a band, so
# the task is not learned in that budget (on an H100, at the learning rate
# at which ids below 512 are learned within 40 steps, a teacher on all
# 30000 ids stayed at chance over 120 steps).  The model keeps its
# 30000-row table.
TRAIN_DATA_VOCAB = 512
TEACHER_STEPS = 80
PHASE1_STEPS = 40
PHASE2_STEPS = 30
TRAIN_COMPARE_STEPS = 3
# card against CPU over the compared steps, activation quantization off:
# losses within 1e-4 relative, every param within 1e-4 (float32 sums in
# another order) but at Adam's ties (the two gradients of opposite signs,
# or one within 100 eps of 0: see compare_train_steps), masks equal away
# from ties (no tile norm within 1e-6 of the threshold).  With activation quantization on, one step: its loss,
# taken before any update, within 1e-4 relative (an AF flip moves one
# activation by a quantum); its params are reported, not held, since a
# flip's gradient difference can reverse the sign of an Adam step.
TRAIN_RTOL = 1e-4
TRAIN_ATOL = 1e-4
TIE = 1e-6


def train_config():
    """launch/finetune.py's config at the published width, its pruning in
    32x32 tiles (the block-sparse kernel's) and its schedule over
    PHASE1_STEPS; the config's own distillation weight (0.5)."""
    from repro_torch.launch.finetune import finetune_config

    return finetune_config(True, PHASE1_STEPS, block_size=32)


def mask_mismatches(card_masks, cpu_masks, cpu_params, sparsity: float, block: int) -> dict:
    """Elements where the card's and the CPU's masks differ, away from ties:
    a tile may differ only where its L2 norm (of the CPU's params) lies
    within ``TIE`` of the threshold.  Returns {path: count} of the rest and
    the tiles within ``TIE`` of the threshold (the threshold's own
    included)."""
    import numpy as np

    from repro_torch.common.util import tree_leaves_with_path

    params = dict(tree_leaves_with_path(cpu_params))
    cpu = dict(tree_leaves_with_path(cpu_masks))
    bad, at_threshold = {}, 0
    for path, m in tree_leaves_with_path(card_masks):
        w = params[path].abs().numpy()
        r, c = w.shape
        wp = np.pad(w, ((0, (-r) % block), (0, (-c) % block)))
        bs = np.sqrt((wp.reshape(wp.shape[0] // block, block, wp.shape[1] // block, block) ** 2).sum(axis=(1, 3)))
        flat = np.sort(bs.reshape(-1))
        k = int(np.floor(np.float32(flat.size) * np.float32(sparsity)))
        near = np.zeros_like(bs, bool) if k <= 0 else np.abs(bs - flat[k - 1]) <= TIE
        at_threshold += int(near.sum())
        near = np.repeat(np.repeat(near, block, 0), block, 1)[:r, :c]
        n = int(((m.cpu().numpy() != cpu[path].numpy()) & ~near).sum())
        if n:
            bad[path] = n
    return {"mismatches": bad, "tiles_at_threshold": at_threshold}


def compare_train_steps(cfg, params, teacher, data, tcfg, dev, steps: int) -> dict:
    """``steps`` phase-1 steps of the same trainer on the card and on the
    CPU from the same weights: per-step losses, the gradients, every param
    after the last step, the masks (under the tie rule).

    A param may differ by more than ``TRAIN_ATOL`` only where Adam's step is
    ill-conditioned in the gradient at some step (its ties): where the
    card's and the CPU's gradients took opposite signs (the first update is
    sign(g) * lr, so a gradient zero up to rounding moves its element by
    about lr either way), or where the two differ and one is within 100 eps
    of 0 (g / (|g| + eps) then turns the gradient's last digits into a
    visible fraction of lr).  Those elements are counted, with their largest
    difference."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.common.util import tree_leaves_with_path
    from repro_torch.core.pruning import sparsity_schedule
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import EdgeBertTrainer

    runs, last, grads = {}, {}, {"cuda": [], "cpu": []}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        tr = EdgeBertTrainer(build_model(cfg), dataclasses.replace(tcfg, phase1_steps=steps),
                             teacher_params=tree_to(teacher, d))
        step_fn = tr.phase1_step

        def recording(*a, _fn=step_fn, _w=where):
            out = _fn(*a)
            grads[_w].append({k: v.cpu() for k, v in tree_leaves_with_path(out[2])})
            return out

        tr.phase1_step = recording
        t0 = time.perf_counter()
        runs[where] = tr.phase1(tree_to(params, d), data, log_every=10 ** 9,
                                callbacks=[lambda step, p, m, _w=where: last.__setitem__(_w, p)])
        runs[where + "_s"] = time.perf_counter() - t0
    (gp, gs, gh), (cp, cs, ch) = runs["cuda"], runs["cpu"]
    loss_rel = [abs(g["loss"] - c["loss"]) / abs(c["loss"]) for g, c in zip(gh, ch)]
    cpu_leaves = dict(tree_leaves_with_path(cp))
    param_err, grad_rel, ties, over = {}, {}, 0, {}
    for path, leaf in tree_leaves_with_path(gp):
        diff = (leaf.cpu() - cpu_leaves[path]).abs()
        param_err[path] = float(diff.max())
        tie = torch.zeros_like(diff, dtype=torch.bool)
        for g_card, g_cpu in zip(grads["cuda"], grads["cpu"]):
            tie |= (torch.sign(g_card[path]) != torch.sign(g_cpu[path]))
            tie |= (torch.minimum(g_card[path].abs(), g_cpu[path].abs()) < 100 * tcfg.opt.eps) & (
                g_card[path] != g_cpu[path])
            scale = float(g_cpu[path].abs().max())
            grad_rel[path] = max(grad_rel.get(path, 0.0),
                                 float((g_card[path] - g_cpu[path]).abs().max()) / scale if scale else 0.0)
        ties += int(tie.sum())
        bad = (diff > TRAIN_ATOL) & ~tie
        if bad.any() or (tie & (diff > TRAIN_ATOL)).any():
            over[path] = {"over_atol": int((diff > TRAIN_ATOL).sum()), "unexcused": int(bad.sum()),
                          "max_excused": float(diff[tie].max()) if tie.any() else 0.0,
                          "max_unexcused": float(diff[bad].max()) if bad.any() else 0.0}
    s = float(sparsity_schedule(steps - 1, cfg.edgebert.prune.encoder_sparsity, cfg.edgebert.prune.begin_step,
                                cfg.edgebert.prune.end_step))
    masks = mask_mismatches(gs.masks, cs.masks, tree_to(last["cpu"], torch.device("cpu")), s,
                            cfg.edgebert.prune.block_size)
    return {"steps": steps, "losses_card": [h["loss"] for h in gh], "losses_cpu": [h["loss"] for h in ch],
            "loss_rel_err": loss_rel, "param_max_abs_err": max(param_err.values()),
            "grad_max_rel_err": max(grad_rel.values()), "adam_tie_elements": ties,
            "params_over_atol": over,
            "unexcused": sum(v["unexcused"] for v in over.values()),
            "mask_sparsity": s, **masks, "card_s": runs["cuda_s"], "cpu_s": runs["cpu_s"],
            "span_z_card": [float(x) for x in gp["span_z"].cpu().reshape(-1)[:4]],
            "span_z_cpu": [float(x) for x in cp["span_z"].reshape(-1)[:4]],
            "grad_norm_rel_err": [abs(g["grad_norm"] - c["grad_norm"]) / c["grad_norm"] for g, c in zip(gh, ch)],
            "finite": bool(np.isfinite([h["loss"] for h in gh]).all())}


def compare_train_forward(model, params, batch, dev) -> dict:
    """The training forward (activation quantization on) of one batch on
    the card and on the CPU: every off-ramp's logits and the final loss."""
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.training.losses import offramp_loss

    outs = {}
    with torch.no_grad():
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            out = model.apply_train(tree_to(params, d), tree_to(batch, d))
            outs[where] = (out.all_cls_logits.cpu(), float(offramp_loss(out.all_cls_logits, batch["labels"].to(d))),
                           time.perf_counter() - t0)
    (gl, gloss, _), (cl, closs, cpu_s) = outs["card"], outs["cpu"]
    return {"logits_max_abs_err": float((gl - cl).abs().max()), "offramp_loss_card": gloss,
            "offramp_loss_cpu": closs, "cpu_s": cpu_s, "tolerance": f"atol {FULL_WIDTH_ATOL}"}


def held_out_accuracy(model, params, batch) -> dict:
    import torch

    with torch.no_grad():
        out = model.apply_train(params, batch)
    labels = batch["labels"].long()
    return {"final_offramp": float((out.all_cls_logits[-1].argmax(-1) == labels).float().mean()),
            "at_exit": float((out.cls_logits.argmax(-1) == labels).float().mean()),
            "mean_exit": float(out.exit_layer.float().mean())}


def run_train_path(dev) -> dict:
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.device import tree_to
    from repro_torch.common.util import tree_leaves_with_path, tree_num_params
    from repro_torch.core.adaptive_span import hard_spans
    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.core.pruning import measured_sparsity
    from repro_torch.data.synthetic import SyntheticCLS
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.launch.finetune import LR, quantize_for_deploy, serve_trained, trainer_for
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.deploy import deploy_albert
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, default_albert_controller, no_early_exit_baseline
    from repro_torch.training.optim import adamw_init
    from repro_torch.training.train_loop import make_train_step, to_batch

    t_phase = time.perf_counter()
    cfg = train_config()
    model = build_model(cfg)
    B, S = 16, 128
    data = SyntheticCLS(TRAIN_DATA_VOCAB, S, B, num_classes=cfg.num_classes, seed=0)
    held_out = to_batch(data.batch(20_000), dev)
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    trainer = trainer_for(model, PHASE1_STEPS, PHASE2_STEPS, lr=LR["full"])
    acc_init = held_out_accuracy(model, params, held_out)

    # every training step on the card, counted: no kernel may launch
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    laps = {}

    # 1. the teacher: the generic step, pruning off
    t0 = time.perf_counter()
    tcfg_teacher = cfg.with_edgebert(prune=dataclasses.replace(cfg.edgebert.prune, enabled=False))
    step_fn = make_train_step(build_model(tcfg_teacher), trainer.tcfg.opt)
    teacher, opt_state, teacher_losses = params, adamw_init(params), []
    for step in range(TEACHER_STEPS):
        teacher, opt_state, m = step_fn(teacher, opt_state, to_batch(data.batch(step), dev))
        teacher_losses.append(float(m["loss"]))
    laps["teacher_s"] = time.perf_counter() - t0
    acc_teacher = held_out_accuracy(model, teacher, held_out)

    # 2. card against CPU on the first phase-1 steps from the teacher's
    # weights, with the teacher: activation quantization off, then on
    t0 = time.perf_counter()
    cfg_nq = cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, enabled=False))
    cmp_nq = compare_train_steps(cfg_nq, teacher, teacher, data, trainer.tcfg, dev, TRAIN_COMPARE_STEPS)
    cmp_q = compare_train_forward(model, teacher, to_batch(data.batch(0), "cpu"), dev)
    laps["card_vs_cpu_s"] = time.perf_counter() - t0

    # 3. phase 1 from the teacher's weights, distilling from it; 4. phase 2
    trainer.teacher_params = teacher
    t0 = time.perf_counter()
    stamps = []
    p1, prune_state, h1 = trainer.phase1(teacher, data, log_every=10 ** 9,
                                         callbacks=[lambda *a: stamps.append(time.perf_counter())])
    laps["phase1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained, h2 = trainer.phase2(p1, data, log_every=10 ** 9)
    torch.cuda.synchronize()
    laps["phase2_s"] = time.perf_counter() - t0
    train_launches = ops.launch_counts()
    if any(train_launches.values()):
        raise AssertionError(f"kernels launched during training: {train_launches}")

    # one phase-1 step alone: wall (host clock around a synchronised step)
    # and device busy time (profiled)
    masks = prune_state.masks
    step_batch = to_batch(data.batch(0), dev)
    step_state = adamw_init(p1)

    def one_step():
        trainer.phase1_step(p1, step_state, step_batch, masks)

    one_step()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    by_kernel = profile_device(one_step)
    busy = sum(g["ms"] for g in by_kernel.values())
    step_ms = float(np.median(walls))
    # the step's operations: 2 FLOPs per multiply-add of the student's
    # forward, twice that for its backward, and the teacher's forward
    d, ff, V, E = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.embed_dim
    fwd_per_token = cfg.n_layers * (2 * 4 * d * d + 2 * 2 * d * ff + 2 * 2 * S * d) + 2 * E * d
    step_flops = 4.0 * fwd_per_token * B * S

    # checkpoint round trip of the trained tree (sha256 checked on restore)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckdir:
        mgr = CheckpointManager(ckdir, save_every=1, keep=2)
        t0 = time.perf_counter()
        mgr.maybe_save(PHASE1_STEPS + PHASE2_STEPS, {"params": trained}, force=True)
        restored, manifest = mgr.restore_latest({"params": trained})
        ckpt_s = time.perf_counter() - t0
        same = all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(tree_leaves_with_path(restored), tree_leaves_with_path({"params": trained})))
        if not same or manifest["step"] != PHASE1_STEPS + PHASE2_STEPS:
            raise AssertionError("the checkpoint did not restore the trained tree bit for bit")

    sparsity = measured_sparsity(p1, prune_state)
    spans = hard_spans(trained["span_z"].cpu().numpy()[0])
    acc_after = held_out_accuracy(model, trained, held_out)
    p2_losses = [h["loss"] for h in h2]
    result = {
        "phase": "train", "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "params": tree_num_params(params), "batch": B, "seq_len": S, "lr": trainer.tcfg.opt.lr,
        "steps": {"teacher": TEACHER_STEPS, "phase1": PHASE1_STEPS, "phase2": PHASE2_STEPS},
        "teacher_losses": teacher_losses, "phase1_losses": [h["loss"] for h in h1], "phase2_losses": p2_losses,
        "phase2_first10_mean": float(np.mean(p2_losses[:10])), "phase2_last10_mean": float(np.mean(p2_losses[-10:])),
        "held_out_accuracy": {"init": acc_init, "teacher": acc_teacher, "trained": acc_after},
        "span_z": [float(z) for z in trained["span_z"].cpu().reshape(-1)],
        "learned_spans": [int(s_) for s_ in spans], "dead_heads": int((spans == 0).sum()),
        "measured_sparsity": sparsity,
        "card_vs_cpu": cmp_nq, "card_vs_cpu_quantized": cmp_q,
        "train_launches": train_launches,
        "step_wall_ms": walls, "step_wall_ms_median": step_ms, "step_device_busy_ms": busy,
        "step_device_idle_share": (1.0 - busy / step_ms) if busy > 0 else None,
        "step_device_ms_by_kernel": by_kernel, "step_tflop": step_flops / 1e12,
        "step_fp32_bound_ms": step_flops / FP32_FLOP_PER_S * 1e3,
        "phase1_step_ms": (np.diff(stamps) * 1e3).tolist(),
        "checkpoint": {"seconds": ckpt_s, "sha256": manifest["sha256"], "arrays": len(manifest["keys"]),
                       "bit_identical": same},
        "seconds": dict(laps),
    }
    # the training record goes out before its checks, so a failed check
    # still leaves its numbers in the output
    emit({**result, "phase": "train_training"})
    if not np.mean(p2_losses[-10:]) < np.mean(p2_losses[:10]):
        raise AssertionError(f"phase-2 loss did not fall: {p2_losses}")
    if not np.isfinite([h["loss"] for h in h1]).all():
        raise AssertionError("non-finite phase-1 loss")
    if max(cmp_nq["loss_rel_err"]) > TRAIN_RTOL or cmp_nq["unexcused"]:
        raise AssertionError(f"card and CPU training differ: {cmp_nq}")
    if cmp_nq["mismatches"]:
        raise AssertionError(f"card and CPU masks differ away from ties: {cmp_nq['mismatches']}")
    if cmp_q["logits_max_abs_err"] > FULL_WIDTH_ATOL:
        raise AssertionError(f"card and CPU quantized training forward differ: {cmp_q}")

    # deploy and serve the trained weights on the card (launch/finetune.py's
    # tail): AF8 post-quantization, the embedding through the MLC2 eNVM,
    # deploy_albert -> classify_with_dvfs, then a ClassifierServer drain
    # with a shared-clock arbiter; every kernel of ops.FINETUNE_KERNELS
    t0 = time.perf_counter()
    params_q, qstats = quantize_for_deploy(trained, seed=0)
    dep = deploy_albert(params_q, cfg, envm_cell="MLC2", seed=0, device=dev)
    tokens = data.batch(30_000)["tokens"]
    thr = cfg.edgebert.early_exit.entropy_threshold
    dep.threshold = 0.0
    dep.classify(tokens)
    profile = np.asarray(dep.last_entropy_traces)
    below = np.concatenate([profile[:, :-1] < thr, np.ones((B, 1), bool)], axis=1)
    profile_exits = np.argmax(below, axis=1) + 1
    dep.threshold = thr
    target = no_early_exit_baseline(albert_layer_stats(seq_len=S))["latency_s"]

    def controller():
        return default_albert_controller(target, seq_len=S, n_layers=cfg.n_layers,
                                         predictor=fit_exit_predictor(profile[:, 0], profile_exits, n_bins=8))

    ctl = controller()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    logits, exits, lane_reports = dep.classify_with_dvfs(tokens, ctl, arbiter=BatchedDVFSArbiter(ctl))
    deploy_launches = ops.launch_counts()
    _, _, reports = dep.classify_with_dvfs(tokens, ctl)
    ops.reset_launch_counts()
    served = serve_trained(model, params_q, tokens, dev, lanes=8, arbiter=BatchedDVFSArbiter(controller()))
    torch.cuda.synchronize()
    serve_launches = ops.launch_counts()
    laps["deploy_and_serve_s"] = time.perf_counter() - t0
    launches = {k: deploy_launches[k] + serve_launches[k] for k in deploy_launches}
    missing = [k for k in ops.FINETUNE_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the trained weights: {missing}")
    if not np.isfinite(logits).all() or not ((exits >= 1) & (exits <= cfg.n_layers)).all():
        raise AssertionError("deployed logits or exits out of range on the trained weights")
    if not np.array_equal(exits, profile_exits):
        raise AssertionError(f"exits {exits} differ from the profile's {profile_exits}")
    if served["sentences"] != B:
        raise AssertionError(f"served {served['sentences']} of {B}")

    # span_attention at the learned spans against its plain version (the
    # deployed shape; not counted)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(B, S, cfg.n_heads, cfg.head_dim, generator=g, device=dev) for _ in range(3))
    got = ops.span_attention_op(q, k, v, dep.spans, causal=False)
    want = ops.span_attention_op(q.cpu(), k.cpu(), v.cpu(), dep.spans, causal=False)
    span_err = float((got.cpu() - want).abs().max())
    if span_err > 2e-5:
        raise AssertionError(f"span_attention at the learned spans: max abs err {span_err} > 2e-5")

    def ops_of(points):
        return sorted({f"{p.vdd:.3f}V/{p.freq_hz / 1e6:.0f}MHz" for p in points})

    serve_ops = sorted({f"{r.op_vdd:.3f}V/{r.op_freq_hz / 1e6:.0f}MHz" for r in served["requests"]
                        if r.op_vdd is not None})
    result.update({
        "deployed_spans": [int(s_) for s_ in dep.spans], "quantize": qstats, "threshold": thr,
        "deploy_exit_histogram": np.bincount(exits, minlength=cfg.n_layers + 1)[1:].tolist(),
        "serve_exit_histogram": np.bincount(served["exits"], minlength=cfg.n_layers + 1)[1:].tolist(),
        "deploy_ops": ops_of(r.op for r in reports),
        "deploy_arbiter_slowest_ops": ops_of(r.slowest_op for r in lane_reports), "serve_ops": serve_ops,
        "modeled_energy_j": float(sum(r.energy_j for r in reports)),
        "serve_avg_exit_layer": served["avg_exit_layer"], "span_attention_learned_err": span_err,
        "launches": launches, "deploy_launches": deploy_launches, "serve_launches": serve_launches,
        "seconds": laps, "phase_s": time.perf_counter() - t_phase,
    })
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

    seconds: dict = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    rows = timed("kernel", check_kernels, dep, cfg, sparams, dev)
    timed("reference", check_reference, dep, params, cfg, dev)
    timed("serving_reference", check_serving_reference, scfg, sparams, dev)
    main_path = timed("main", run_main_path, dep, cfg, dev)
    serving = timed("serving", run_serving_path, scfg, sparams, dev)
    replay = timed("replay", run_replay_path, scfg, dev)
    decode = timed("decode", run_decode_path, dev)
    moe_decode = timed("moe_decode", run_decode_path, dev, "qwen2_moe_a2p7b")
    train = timed("train", run_train_path, dev)
    emit({"phase": "seconds", "by_phase": seconds})
    for r in rows:
        by_path = {"deploy": main_path["launches"][r["name"]], "serving": serving["launches"][r["name"]],
                   "replay": replay["launches"][r["name"]], "decode": decode["launches"][r["name"]],
                   "moe_decode": moe_decode["launches"][r["name"]], "train": train["launches"][r["name"]]}
        # the launches of the path whose shapes the row was timed at: the
        # replay's, the deployed path's for af_matmul, which only that path
        # runs, or the decode or moe_decode path's for the wide-row entropy
        r["launches"] = by_path[r["path"]]
        r["launches_by_path"] = by_path
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']} was not launched on the {r['path']} path")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms", "library_device_ms", "path", "shape",
            "launches_by_path")
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
