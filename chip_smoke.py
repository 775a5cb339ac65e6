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
                102400], [4 and 1, 151936] and [4 and 1, 256000] logits
                beside the warp-per-row entry, at [4 and 1, 102400] in
                bf16 (the decoders' own dtype), and layernorm at the
                decoders' [4 and 1, 4096] rows (its generic path) and at
                whisper-medium's [4 and 1, 1024] (its register path), and
                quantize_groups at the eb_decode shapes ([4, 4096] in 4
                groups and in 1, [2, 4096] in 1), bit for bit on a
                second launch;
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
 6b. sharded  — lane-sharded serving on the serving phase's config,
                weights, requests, threshold and controller: a
                ClassifierServer of 2 replicas x 4 lanes (cuda:0 and cuda:1
                with two cards, else both named on cuda:0; the line gives
                "devices" and "cards"), one clock domain per replica, then
                2R contracts admitted at their own quote under
                LeastLoadedPlacement; every serving kernel launched, zero
                accepted-SLO misses, one build per (bucket, 2), exits equal
                to the unsharded 8-lane drain's and logits within 5e-2,
                every AF flip between the slabs' and the flat step's layer
                outputs one grid step at a boundary (shard_flips, at each
                bucket), each domain's clock, energy and switches, drain
                wall and busy ms, idle share and requests/s beside the
                unsharded drain's (in turns), and every launcher on every
                card leaving the current device as it found it;
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
 7b. encoder  — ModernBERT-large at full width and depth (28 unshared
                layers, d 1024, 16 x 64 heads, GeGLU of 2 x 2624, windows
                65 and 8192; the weights drawn on the card, every MLP
                pruned to 0.5 in 32x32 tiles): the encoder step's kernels
                at its shapes against their plain versions (span attention
                at [16, 8192, 16, 64] with per-lane kv_len, window 8192 and
                65; block_sparse on w_up and w_down, the scale-only
                layernorm and af_quantize at 1 and 16 lanes of 8192 rows),
                each with its device time and bound; 24 seeded documents of
                6144-8192 tokens through a ClassifierServer of 16 lanes,
                each lane at its own layer: activation quantization off,
                the kernel route against the plain route at a threshold
                from a full-depth drain (exits equal, entropies and exit
                logits within 1e-4); then the deployed stack (AF(8, 3),
                a shared-clock arbiter), the launch counts zeroed just
                before the drain and matched to the engine's layer log
                (span_attention, af_quantize once and block_sparse_matmul
                twice per depth group, layernorm twice but once at layer
                0, nothing else), more depth groups than steps, its
                documents/s and the drain's peak memory.
  8. decode   — the dense decoder at full width (deepseek-7b: its first
                10 of 30 layers, cut for the script's time; d_model 4096,
                32 x 128 heads, d_ff 11008, vocab 102400, float32 weights
                drawn on the card from seed 0):
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
                entropy within 1e-4); and the same traffic through a
                DecoderServer of 2 replicas x 2 lanes (the sharded phase's
                devices) at W = 1 and W = 4: tokens and exits equal to the
                unsharded drains', W = 4 equal to W = 1 bit for bit,
                softmax_entropy launched 2 x n_layers x W per fused step
                and nothing else.
 8a. eb_decode — the decode phase's weights (before they are released)
                with EdgeBERT's features on: AF(8,3) activation
                quantization after every layer and adaptive spans, span_z
                drawn from seed 1 in [0, 8]; the decode recipe's probe and
                drains at W = 1 and 4: af_quantize (quantize_groups, one
                group per lane) launched n_layers x W times per fused step
                and n_layers times per prefill token (one group over the
                prefill's batched step), softmax_entropy n_layers x W per
                fused step, nothing else (ops.EB_DECODE_KERNELS); W = 4
                equal to W = 1 bit for bit, one decode and one prefill
                build per bucket; drains, a fused step and a prefill timed
                beside the decode phase's; the first 2 layers against the
                CPU, teacher-forced, every AF flip one grid step at a
                rounding boundary.
 8b. moe_decode — the same recipe on the MoE decoder at full width
                (qwen2-moe-a2.7b: its first 8 of 24 layers, cut for the
                script's time, d_model 2048, 16 x 128 heads with qkv biases
                drawn nonzero, 60 experts of d_ff 1408 top-4 and a shared
                expert of 5632, vocab 151936; the float32 weights drawn on
                the card after the decode phase's are released, the free
                memory checked and reported before and after the draw):
                softmax_entropy's wide-row entry launched 8 x W times per
                fused step, W = 4
                equal to W = 1 bit for bit, the step's bytes by part
                (experts, LM head, shared expert, attention) beside its
                HBM bound, and the first 2 layers against the CPU.
 8c. ln_decode — the same recipe on the LayerNorm decoder at full width
                (minitron-8b: its first 16 of 32 layers, cut for the
                script's time; d_model 4096, 32 x 128 query heads over 8
                KV heads, squared-ReLU MLP of d_ff 16384, vocab 256000;
                drawn on the card after the MoE weights are released):
                layernorm launched 3 n_layers x W times per fused step
                (both pre-norms of every layer and the final norm of
                every off-ramp) and 2 n_layers + 1 times per prefill
                token, softmax_entropy's wide-row entry n_layers x W times
                per fused step, W = 4 equal to W = 1 bit for bit, the step's
                bytes beside its HBM bound, and the first 2 layers against
                the CPU.
 8d. ssm_decode — the RWKV6 decoder at full width (rwkv6-7b: its first
                16 of 32 layers, cut for the script's time;
                d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab 65536;
                the weights drawn on the card): a DecoderServer
                drain of the same traffic, plain decode (no exit in this
                family) with a shared-clock arbiter; layernorm launched
                once per fused step and once per prefill token (the final
                norm only: the per-layer LayerNorms stay on torch ops, as
                in the JAX package), nothing else; the same requests
                submitted in reverse order (other lanes, other requests
                before them in each lane) give each request the same
                tokens, since a refill zeroes the lane's recurrent state;
                drain times, the fused step and the prefill profiled
                alone beside the step's HBM bound; then the card against
                the CPU on the first 2 layers (logits of every step, and
                the recurrent state after the prompt, within 1e-4), and
                layer 0's error op by op (each op on the card from the
                CPU's inputs, and the card's own chain).
 8e. hybrid_decode — the hybrid decoder at full width and depth
                (zamba2-1.2b: 38 Mamba2 blocks of d_model 2048, d_inner
                4096, 64 SSD heads of 64, state 64; the shared attention
                block after every 6th block at width 4096, 32 x 128 heads,
                d_ff 8192; vocab 32000; 4.98 GB drawn on the card): the
                ssm_decode recipe, with no kernel launched (RMS norms, cache
                attention on torch ops, as in the JAX package); the reverse
                order the same tokens; Model.prefill (the chunked SSD) of
                every prompt against the server's one-token prefill (logits,
                conv and SSM state within 1e-4 of each leaf's largest
                magnitude); the first 6 blocks (one shared-block call)
                against the CPU: every step's logits within 1e-4, the state
                after the prompt within 1e-4 of each leaf's largest
                magnitude, and block 0's error op by op (as ssm_decode
                reports rwkv6-7b's layer 0: w_in, the conv, the SSD step,
                the gate, w_out).
 8f. encdec_decode — the encoder-decoder at full width and depth
                (whisper-medium: 24 + 24 layers of d_model 1024, 16 x 64
                heads, d_ff 4096, vocab 51865, 1500 frames; 5.40 GB drawn)
                through the model's own entry points: seeded frames
                [4, 1500, 1024] x 0.1, init_cache(4, 32) -> prefill of
                16-token prompts with aux={"enc_input": frames} -> 8 greedy
                decode_step calls on the kernel route; layernorm launched
                once per step (the final norm) and nothing else, none in
                the prefill; frames from another seed change the logits;
                then served as the JAX server serves it (no frames reach
                the server: zero cross K/V, the prefill one-token
                decode_steps): the ssm_decode recipe's drains, layernorm
                once per fused step and once per prefill token and nothing
                else, the reverse order the same tokens; the encoder, the
                prefill and a decode step timed and profiled alone beside
                their bounds (fp32 operations; the step's bytes); the first
                2 encoder and 2 decoder layers against the CPU (the
                prefill's and every teacher-forced step's logits within
                1e-4).
 8g. vlm_decode — the vision decoder at full width (llama-3.2-vision-90b:
                d_model 8192, 64 x 128 query heads over 8 KV heads, d_ff
                28672, vocab 128256, 1601 image tokens), its first 10 of
                100 layers (2 groups of 4 self layers and a gated cross
                layer; 42.6 GB drawn; the whole model's 350.7 GB exceed the
                card), the cross layers' gates drawn nonzero and printed:
                prefill over seeded image embeddings [4, 1601, 8192] x 0.1
                then 8 greedy decode steps, an image from another seed
                moving the logits; then served as the JAX server serves it
                (no image: zero image K/V): the ssm_decode recipe's drains;
                no kernel launched anywhere; the fused step, one request's
                serving prefill and the model's prefill profiled alone
                beside their bounds; the first group (4 self layers and 1
                cross layer) against the CPU, logits within 1e-4 of their
                magnitude.
 8h. lm_train — zamba2-1.2b trained at full width and depth (float32,
                SyntheticLM batches of 4 x 128 tokens, one SSD chunk): the
                first batch's gradients all finite, and under remat_policy
                "dots" and "full" within 1e-6 of each leaf's largest
                magnitude of those under "none"; 3 AdamW steps through
                make_train_step with finite losses and gradient norms, no
                kernel launched; one step profiled alone beside its fp32
                bound (6 N T operations) and beside the dry run's
                H100_SXM roofline bound of the same step (launch/dryrun.py
                on fake tensors at world 1: per-device FLOPs and bytes,
                busy / bound printed, not asserted; no launch, as
                ops.DRYRUN_KERNELS is empty); the step under each of the
                three policies: wall and busy ms and peak memory; the
                first 6 blocks against the CPU (the loss within 1e-4
                relative, every gradient leaf within 1e-4 of its largest
                magnitude); then one AdamW step under "full" at train_4k's
                sequence, 4 x 4096 (the dry run's temp for it at most
                60 GB, or the phase fails), a step "none" cannot hold:
                its wall ms and peak memory beside the dry run's peak for
                it and its temp under "none".  The dry-run cells are
                traced in spawned processes beside the build, and joined
                before the first timed phase.
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
 10. bf16_decode — deepseek-7b's smoke config in its own dtype (bf16)
                through decode_step_ee with the kernels on the card against
                the CPU's plain path (the entropy kernel on bf16 logits,
                n_layers launches a step, nothing else).
 11. dist_train — the training half of sharding over torch.distributed,
                in spawned ranks: min(cards, 4) ranks over NCCL, one card
                each (world 1 on one card), and 2 ranks both on cuda:0 over
                gloo (NCCL refuses two ranks on one device); each runs
                qwen3-moe-235b's MoE layer at its published width (d_model
                4096, 128 experts of moe_d_ff 1536, top-8, fp32: 9.66 GB
                of expert weights split over the model ranks of a (data 1,
                model ranks) mesh) through apply_moe_shardmap, forward and
                backward on 4 x 128 tokens, held against the same layer
                unsharded on the card (outputs and every gradient within
                1e-5 of their magnitude), compressed_psum over its
                gradients equal to a one-rank reference from the gathered
                gradients and timed beside a plain fp32 all_reduce of the
                same tree, and (NCCL) pipeline_forward with one stage of
                4096 x 4096 linear + tanh per rank against the sequential
                stack, and its gradient (each stage's weight gradient and
                the input's within 1e-5 of their magnitude of the
                sequential stack's autograd; the stage count and errors
                printed); no kernel launched (ops.DIST_TRAIN_KERNELS is
                empty); wall and busy ms of the layer's forward and
                backward, ranks, backends, cards and nvidia-smi's line.
Then each phase's seconds, the `{"kernels": [...]}` summary (one row per
kernel, at the replay's largest step shape with the replay's launches, or
for af_matmul, which only the deployed path runs, at the deployed layer
with that path's launches; softmax_entropy has two more rows, its wide-row
entry at the decode shape [4, 102400] with the decode phase's launches,
at the moe_decode shape [4, 151936] with that phase's and at the ln_decode
shape [4, 256000] with that phase's; layernorm three more, at [4, 4096] with
the ln_decode and the ssm_decode phases' launches and at [4, 1024] with the
encdec_decode phase's served drain's; af_quantize one more, at the
eb_decode shape [4, 4096] in 4 groups with that phase's launches;
`launches_by_path` gives every path's, encoder, eb_decode,
hybrid_decode, encdec_decode, vlm_decode, lm_train, dist_train, dryrun (all zero)
and sharded (the sharded classifier drain's and the sharded W = 1 decode
drain's) included;
every kernel row also checks that the launch left the current device as it
found it),
the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.  Any failure raises: the script exits
non-zero and prints no final line.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero at once.  A copy of every
line also goes to build/chip_smoke.json.
"""
from __future__ import annotations

import json
import math
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
# (minitron-8b, ln_decode, and rwkv6-7b, ssm_decode, take the same traffic)
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

    start_dev = torch.cuda.current_device()

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
        if torch.cuda.current_device() != start_dev:
            raise AssertionError(f"{name} ({shape}): the launch left cuda:{torch.cuda.current_device()} "
                                 f"current, not cuda:{start_dev}")
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
    # deepseek-7b's vocabulary (102400), qwen2-moe's (151936) and
    # minitron-8b's (256000), each at 4 lanes (a summary row, with the
    # decode, moe_decode or ln_decode phase's launches) and one lane;
    # entropy within 1e-5 of the plain version (the determinism phase
    # launches it twice at these shapes for the same bits).  Beside it the
    # warp-per-row entry on the same logits (`replaced_device_ms`: probs and
    # entropy, what this entry replaced on the decode path) and an empty
    # launch.
    # Bound: one read of the logits.
    from repro_torch.kernels.softmax_entropy import entropy as entropy_rows

    for path, arch in (("decode", "deepseek_7b"), ("moe_decode", "qwen2_moe_a2p7b"), ("ln_decode", "minitron_8b")):
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

    # ... and at deepseek-7b's [lanes, 102400] in bf16, the decoders' own
    # dtype: read as bf16, computed in fp32 (the JAX kernel casts its rows),
    # within 1e-5 of the plain version on the same bf16 values, beside the
    # fp32 rows above.  Bound: one read of the bf16 logits.
    vocab = get_config("deepseek_7b").vocab_size
    for rows_ in (DECODE_LANES, 1):
        lg = (torch.randn(rows_, vocab, generator=g, device=dev) * 1.28).to(torch.bfloat16)
        err = (entropy_rows(lg) - ref.softmax_entropy(lg)[1]).abs().max().item()
        row("softmax_entropy", "src/repro_torch/csrc/softmax_entropy.cu",
            "src/repro/kernels/softmax_entropy.py:17",
            f"decode LM-head entropy (wide-row entry): logits [{rows_}, {vocab}] bf16", err,
            "atol 1e-5 (entropy)", err <= 1e-5, rows_ * vocab * 2 + rows_ * 4, 8.0 * rows_ * vocab,
            **kernel_times(lambda: entropy_rows(lg), lambda: ref.softmax_entropy(lg), enqueue=True),
            launch_floor_device_ms=launch_floor, label=f"decode_bf16[{rows_}]")

    # layernorm at the LayerNorm decoders' rows: d_model 4096 (minitron-8b's
    # pre-norms and off-ramp final norms, rwkv6-7b's final norm), 4 lanes in
    # the fused step (a summary row each, with the ln_decode or ssm_decode
    # phase's launches) and 1 in the prefill.  Above the register path's
    # 1024, so the kernel's generic path (scalar strides, a second pass over
    # the row); within 1e-5 of the plain version (the determinism phase
    # launches it twice at these shapes for the same bits).  And at
    # whisper-medium's d_model 1024 (the final norm of its decode step,
    # encdec_decode's launches): the register path's widest rows.
    for path, arch in (("ln_decode", "minitron_8b"), ("ssm_decode", "rwkv6_7b"),
                       ("encdec_decode", "whisper_medium")):
        dw = get_config(arch).d_model
        route = "register path" if dw <= 1024 else "generic path"
        gw = 1.0 + 0.1 * torch.randn(dw, generator=g, device=dev)
        bw = 0.1 * torch.randn(dw, generator=g, device=dev)
        for rows_ in (DECODE_LANES, 1):
            xw = torch.randn(rows_, dw, generator=g, device=dev) * 3.0
            err = (layernorm(xw, gw, bw) - ref.layernorm(xw, gw, bw)).abs().max().item()
            row("layernorm", "src/repro_torch/csrc/layernorm.cu", "src/repro/kernels/layernorm.py:17",
                f"{path}: [{rows_}, {dw}] fp32 ({route})", err, "atol 1e-5", err <= 1e-5,
                (2 * rows_ * dw + 2 * dw) * 4, 8 * rows_ * dw,
                **kernel_times(lambda: layernorm(xw, gw, bw), lambda: ref.layernorm(xw, gw, bw),
                               lambda: F.layer_norm(xw, (dw,), gw, bw, eps=1e-6), enqueue=True),
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

    # ... and at the eb_decode path's shapes: deepseek-7b's hidden state
    # after a decoder layer, [4 lanes, 4096], one group per lane (the fused
    # steps: the JAX package vmaps each lane's call) and one group over the
    # rows (the serving prefill's batched step, [2, 4096]: the lane and one
    # dummy row; and [4, 4096], the JAX package's 4-lane call); one row at
    # 1e-2 of the others' scale, so the groups take different biases.  atol
    # 0 and equal biases against the plain version on the CPU, and the same
    # bits on a second launch.
    d_eb = get_config("deepseek_7b").d_model
    for rows_, groups in ((DECODE_LANES, DECODE_LANES), (DECODE_LANES, 1), (2, 1)):
        xq = torch.randn(rows_, d_eb, generator=g, device=dev) * 4.0
        xq[0] *= 1e-2
        rpg = rows_ // groups
        e_cpu = group_exp_bias(xq.cpu(), rpg)
        q1, e1 = quantize_groups(xq, rpg)
        q2, e2 = quantize_groups(xq, rpg)
        err = (q1.cpu() - ref.quantize(xq.cpu(), e_cpu, rpg)).abs().max().item()
        same = torch.equal(q1, q2) and torch.equal(e1, e2)
        n = xq.numel()
        row("af_quantize", "src/repro_torch/csrc/af_quantize.cu", "src/repro/kernels/adaptivfloat_k.py:41",
            f"eb_decode: [{rows_}, {d_eb}] fp32, {groups} row group{'s' if groups > 1 else ''} of {rpg}", err,
            "atol 0 and equal biases (against the CPU plain version); the same bits on a second launch",
            torch.equal(e1.cpu(), e_cpu) and err == 0.0 and same, 2 * n * 4 + groups * 4, 20.0 * n,
            **kernel_times(lambda: quantize_groups(xq, rpg), lambda: ref.quantize(xq, e1, rpg), enqueue=True),
            launch_floor_device_ms=launch_floor, second_launch_equal=same,
            summary="eb_decode" if groups > 1 else None, label=f"eb_decode[{rows_}]/{groups}")

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

    for arch in ("deepseek_7b", "qwen2_moe_a2p7b", "minitron_8b"):
        for rows_ in (DECODE_LANES, 1):
            lgv = torch.randn(rows_, get_config(arch).vocab_size, generator=g, device=dev)
            same(f"softmax_entropy wide rows [{rows_}, {lgv.shape[1]}]", lambda: entropy_rows(lgv))
    for rows_ in (DECODE_LANES, 1):
        lgb = torch.randn(rows_, get_config("deepseek_7b").vocab_size, generator=g, device=dev).to(torch.bfloat16)
        same(f"softmax_entropy wide rows [{rows_}, {lgb.shape[1]}] bf16", lambda: entropy_rows(lgb))
    # layernorm's generic path at the LayerNorm decoders' d_model, and its
    # register path at whisper-medium's
    for dw, route in ((4096, "generic path"), (1024, "register path")):
        gw, bw = torch.randn(dw, generator=g, device=dev), torch.randn(dw, generator=g, device=dev)
        for rows_ in (DECODE_LANES, 1):
            xw = torch.randn(rows_, dw, generator=g, device=dev)
            same(f"layernorm [{rows_}, {dw}] ({route})", lambda: layernorm(xw, gw, bw))
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


def layer_steps(cfg, params, dev, kv_lens, bucket: int, slabs=None):
    """A side of ``layer_flips``: the serving layer step before activation
    quantization on ``dev`` (the kernel route), then the per-lane AF
    quantization (``quantize_groups``, the call dispatch.act_quantize
    makes), as a function of the CPU's hidden state -> (pre, quantized,
    biases) on the CPU.  With ``slabs`` (one device per replica) the lanes
    are cut into that many contiguous slabs, each stepped and quantized on
    its device with its own params copy and block masks, as a sharded
    server's fused step runs them."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.core.adaptivfloat import AFFormat
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.adaptivfloat_k import quantize_groups
    from repro_torch.models.model import build_model

    q = cfg.edgebert.quant
    fmt = AFFormat(q.n_bits, q.n_exp)
    model = build_model(cfg.with_edgebert(quant=dataclasses.replace(q, quantize_activations=False)))
    D = cfg.d_model
    placed = {}
    for d in slabs or [dev]:
        d = torch.device(d)
        if d not in placed:
            p = tree_to(params, d)
            placed[d] = (p, dispatch.mlp_block_masks(p["layer"]["mlp"]))
    devs = [torch.device(d) for d in (slabs or [dev])]

    def step(h):
        outs = []
        for hs, kv, d in zip(h.chunk(len(devs)), kv_lens.chunk(len(devs)), devs):
            p, masks = placed[d]
            with torch.no_grad():
                pre = model._dense_layer_step(p["layer"], hs.to(d), causal=False, kv_len=kv.to(d),
                                              use_kernels=True, block_masks=masks, per_lane=True)
                qd, ed = quantize_groups(pre.reshape(-1, D).contiguous(), bucket, fmt=fmt)
            outs.append((pre.cpu(), qd.reshape(pre.shape).cpu(), ed.cpu()))
        return tuple(torch.cat([o[k] for o in outs]) for k in range(3))

    return step, fmt


def flip_check(ref, test, fmt, valid=None) -> dict:
    """One layer's two sides, each (pre-quantization output [groups, ...],
    its AF quantization, the biases [groups]): the largest difference
    before quantization, whether the biases are equal, and the quantized
    elements that differ (flips), each of which must be one step between
    neighbouring grid points whose midpoint lies within the
    pre-quantization difference of the reference's value, so the two values
    straddle an AF rounding boundary.  ``valid`` [groups, S] masks padding
    rows out."""
    import torch

    (pre_c, q_c, e_c), (pre_g, q_g, e_g) = ref, test
    pre_err = (pre_g - pre_c).abs()
    flip = q_g != q_c
    if valid is not None:
        flip = flip & valid[..., None]
    lo = torch.minimum(q_g.abs(), q_c.abs())
    step = af_next_step(lo, e_c.float().reshape((-1,) + (1,) * (q_c.ndim - 1)), fmt)
    one_step = ((q_g * q_c >= 0) & (lo + step == torch.maximum(q_g.abs(), q_c.abs()))) | ~flip
    mid = (q_g + q_c) / 2
    at_boundary = ((pre_c - mid).abs() <= pre_err + 1e-7 * pre_c.abs()) | ~flip
    counted = pre_err if valid is None else pre_err[valid]
    return {"flips": int(flip.sum()), "elements": int(flip.numel() if valid is None else valid.sum() * q_c.shape[-1]),
            "pre_quant_max_abs_err": float(counted.max()),
            "flip_max_abs": float((q_g - q_c)[flip].abs().max()) if flip.any() else 0.0,
            "biases_equal": bool(torch.equal(e_c, e_g)),
            "all_one_step": bool(one_step.all()), "all_at_boundary": bool(at_boundary.all())}


def layer_flips(cfg, params, requests, bucket: int, ref_side, test_side) -> dict:
    """Layer by layer on the reference side's state (teacher forcing), the
    serving layer step before activation quantization on two sides
    (``layer_steps``) at one ``bucket``, then the per-lane AF quantization
    of each.  The two pre-quantization tensors must agree within
    PRE_QUANT_ATOL and give every lane the same bias; every quantized
    element that differs must be a flip at an AF rounding boundary
    (``flip_check``), every other element equal."""
    import numpy as np
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    (ref_step, fmt), (test_step, _) = ref_side, test_side
    lanes = len(requests)
    toks = np.zeros((lanes, bucket), np.int64)
    lens = np.array([len(t) for t in requests], np.int32)
    for i, t in enumerate(requests):
        toks[i, : len(t)] = t
    valid = torch.as_tensor(np.arange(bucket)[None, :] < lens[:, None])       # [lanes, S]
    h = build_model(cfg).embed(tree_to(params, torch.device("cpu")), torch.as_tensor(toks)).float()
    per_layer = []
    for layer in range(cfg.n_layers):
        pre_c, q_c, e_c = ref_step(h)
        r = {"layer": layer + 1, **flip_check((pre_c, q_c, e_c), test_step(h), fmt, valid)}
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


def quant_flips(cfg, params, requests, dev, bucket: int) -> dict:
    """``layer_flips`` of the card (the kernels) against the CPU (their
    plain versions)."""
    import torch

    kv = torch.as_tensor([len(t) for t in requests], dtype=torch.int32)
    return layer_flips(cfg, params, requests, bucket, layer_steps(cfg, params, "cpu", kv, bucket),
                       layer_steps(cfg, params, dev, kv, bucket))


def shard_flips(cfg, params, requests, dev, bucket: int, devices) -> dict:
    """``layer_flips`` of a sharded server's slabs (one per entry of
    ``devices``, each on its card) against the unsharded step over all the
    lanes on ``dev``: the slab's smaller shapes sum in another order
    (split-K, the grouped quantize's clusters), and the flips that makes
    must each be one grid step at an AF boundary."""
    import torch

    kv = torch.as_tensor([len(t) for t in requests], dtype=torch.int32)
    return layer_flips(cfg, params, requests, bucket, layer_steps(cfg, params, dev, kv, bucket),
                       layer_steps(cfg, params, dev, kv, bucket, slabs=devices))


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
    kernels as "other").  Only the CUDA activity is recorded: the host's op
    events add nothing read here, and on a training step of ~30000 ops
    their recording takes seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def profile_parts(parts_fns) -> dict:
    """Each (name, fn, count) run once warm, then timed alone (host clock,
    synchronised) and profiled: wall and busy ms per count, idle share,
    device time by kernel."""
    import torch

    parts = {}
    for name, fn, count in parts_fns:
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
    return parts


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
    full-depth latency target (``fresh(lanes, **kw)``: other lanes, or
    a ClassifierServer's keywords such as ``replicas`` / ``devices``)."""
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

    def fresh(lanes=lanes, **kw):
        controller = default_albert_controller(
            target, seq_len=128, n_layers=cfg.n_layers,
            predictor=fit_exit_predictor(traces[:, 0], profile_exits, n_bins=8))
        return make_server(cfg, params, dev, buckets=BUCKETS, lanes=lanes, threshold=thr,
                           arbiter=BatchedDVFSArbiter(controller), **kw)

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
    return {**result, "ctx": ctx}


# ---------------------------------------------------------------------------
# phase 6b: lane-sharded serving
# ---------------------------------------------------------------------------

SHARDED_REPLICAS = 2


def sharded_devices() -> tuple:
    """(the replicas' devices, the cards present): cuda:0 and cuda:1 with
    two cards or more, else both replicas named on cuda:0 (a server never
    stacks replicas on one card unless they are named)."""
    import torch

    cards = torch.cuda.device_count()
    devs = [f"cuda:{r}" for r in range(SHARDED_REPLICAS)] if cards >= SHARDED_REPLICAS \
        else ["cuda:0"] * SHARDED_REPLICAS
    return devs, cards


def launch_every_kernel(dev) -> list:
    """Every launcher once on small inputs on ``dev``; returns their names
    (the current-device check: where a launch leaves the calling thread's
    current device)."""
    import numpy as np
    import torch

    from repro_torch.core.adaptivfloat import af_encode
    from repro_torch.kernels import block_sparse
    from repro_torch.kernels.adaptivfloat_k import af_matmul, quantize, quantize_groups
    from repro_torch.kernels.layernorm import layernorm
    from repro_torch.kernels.softmax_entropy import entropy, offramp_head, softmax_entropy
    from repro_torch.kernels.span_attention import span_attention

    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8, 64, generator=g, device=dev)
    layernorm(x, torch.ones(64, device=dev), torch.zeros(64, device=dev))
    softmax_entropy(x)
    entropy(torch.randn(2, 4096, generator=g, device=dev))
    h = torch.randn(4, 8, 64, generator=g, device=dev)
    g_host = torch.Generator().manual_seed(8)         # the AF codes are encoded on the host
    pw, cw = torch.randn(64, 64, generator=g_host) / 8, torch.randn(64, 3, generator=g_host) / 8
    pb, cb = torch.zeros(64, device=dev), torch.zeros(3, device=dev)
    offramp_head(h, pw.to(dev), pb, cw.to(dev), cb, threshold=0.5)
    (pc, pe), (cc, ce) = af_encode(pw), af_encode(cw)
    offramp_head(h, pc.to(dev), pb, cc.to(dev), cb, threshold=0.5, e_min=(int(pe), int(ce)))
    af_matmul(x, pc.to(dev), int(pe))
    quantize(x, torch.full((2,), -4, dtype=torch.int32, device=dev), 4)
    quantize_groups(x, 4)
    w = torch.randn(64, 64, generator=g, device=dev) / 8
    mask = np.ones((2, 2), bool)
    mask[1, 0] = False
    block_sparse.block_sparse_matmul(x, w, block_sparse.BlockIndex.build(mask, 32, 32, dev, w=w))
    q = torch.randn(4, 32, 16, generator=g, device=dev)
    span_attention(q, q, q, torch.full((4,), 32, dtype=torch.int32, device=dev), 32, causal=False)
    torch.cuda.synchronize(dev)
    return ["layernorm", "softmax_entropy", "entropy", "offramp_head", "af_matmul", "quantize",
            "quantize_groups", "block_sparse_matmul", "span_attention"]


def check_current_device(cards: int) -> list:
    """From every card as the current one, every launcher on every card:
    each must leave the current device as it found it."""
    import torch

    start, checks = torch.cuda.current_device(), []
    try:
        for cur in range(cards):
            torch.cuda.set_device(cur)
            for target in range(cards):
                names = launch_every_kernel(torch.device("cuda", target))
                if torch.cuda.current_device() != cur:
                    raise AssertionError(f"a launcher on cuda:{target} left cuda:{torch.cuda.current_device()} "
                                         f"current, not cuda:{cur} ({names})")
                checks.append({"current": cur, "launched_on": target, "launchers": len(names)})
    finally:
        torch.cuda.set_device(start)
    return checks


def timed_drain(make, reqs) -> dict:
    """One drain of ``reqs`` on a fresh server (set-up outside the clock):
    wall ms (host clock, synchronised), and busy ms from a profile of a
    second drain on another fresh server."""
    import torch

    srv = make()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serve(srv, reqs)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof_srv = make()
    by_kernel = profile_device(lambda: serve(prof_srv, reqs))
    busy = sum(g["ms"] for g in by_kernel.values())
    return {"wall_ms": wall, "busy_ms": busy, "device_ms_by_kernel": by_kernel}


def run_sharded_path(cfg, params, dev, ctx) -> dict:
    """Lane-sharded serving at full width: the serving phase's config,
    weights, requests, threshold and controller set-up (``ctx``) through a
    ClassifierServer of 2 replicas x 4 lanes (cuda:0 and cuda:1 with two
    cards, else both named on cuda:0), one controller expanded to one
    arbiter per replica, against the unsharded 8-lane server.  The counted
    run serves the 32 requests and then 2R contracts, each admitted at its
    own quote by an AdmissionController with LeastLoadedPlacement: every
    SHARDED_SERVING_KERNELS kernel launched, zero accepted-SLO misses, one
    build per (bucket, 2), each domain's clock, energy and switches.  The
    32 requests' exits equal the unsharded drain's, their logits within
    FULL_WIDTH_ATOL, and at each bucket ``shard_flips`` holds the slabs'
    layer steps to the flat step's with every AF flip one grid step.  The
    current device is unchanged after every launcher on every card.
    Drain wall and busy ms, idle share and requests/s beside the unsharded
    drain's (in turns: flat, sharded, sharded, flat)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.admission import AdmissionController, LeastLoadedPlacement
    from repro_torch.serving.engine import Request

    devices, cards = sharded_devices()
    R, L = SHARDED_REPLICAS, 8 // SHARDED_REPLICAS
    reqs, fresh = ctx["requests"], ctx["fresh"]
    n = len(reqs)
    start_dev = torch.cuda.current_device()

    def sharded():
        return fresh(lanes=L, replicas=R, devices=devices)

    flat = serve(fresh(), reqs)
    srv = sharded()
    if srv.replicas != R or [str(d) for d in srv.devices] != [str(torch.device(d)) for d in devices]:
        raise AssertionError(f"sharded server on {srv.devices}, want {devices}")
    ac = AdmissionController(srv, placement=LeastLoadedPlacement())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for i, t in enumerate(reqs):
        srv.submit(Request(uid=i, tokens=t))
    placement = []
    for j in range(2 * R):
        toks = reqs[j][:32]
        q = ac.quote(Request(uid=n + j, tokens=toks, deadline_s=1e9))
        d = ac.submit(Request(uid=n + j, tokens=toks, deadline_s=q.min_deadline_s))
        if not d.admitted:
            raise AssertionError(f"sharded: contract {n + j} rejected at its own quote {q}")
        placement.append([n + j, q.replica])
    srv.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    tel = srv.telemetry()
    if torch.cuda.current_device() != start_dev:
        raise AssertionError(f"sharded drain moved the current device to {torch.cuda.current_device()}")
    missing = [k for k in ops.SHARDED_SERVING_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the sharded path: {missing}")
    if tel["accepted"] != 2 * R or tel["accepted_slo_misses"] != 0:
        raise AssertionError(f"sharded: accepted {tel['accepted']}, accepted-SLO misses {tel['accepted_slo_misses']}")
    builds = tel["step_traces_per_bucket_replica"]
    if not builds or set(builds.values()) != {1} or not all(k.endswith(f"x{R}") for k in builds):
        raise AssertionError(f"sharded: builds per (bucket, replicas) {builds}")
    exits = [srv.done[i].exit_layer for i in range(n)]
    flat_exits = [flat.done[i].exit_layer for i in range(n)]
    err = max(float(np.abs(srv.done[i].result - flat.done[i].result).max()) for i in range(n))
    if exits != flat_exits or not err <= FULL_WIDTH_ATOL:
        raise AssertionError(f"sharded drain against the unsharded one: exits {exits} / {flat_exits}, "
                             f"logits max abs err {err} (tolerance {FULL_WIDTH_ATOL})")
    results = np.stack([srv.done[i].result for i in range(n + 2 * R)])
    if not np.isfinite(results).all():
        raise AssertionError("sharded logits are not finite")
    flip_reqs = serving_requests(cfg, 8, 128, seed=2)
    flips = [shard_flips(cfg, ctx["params"], [t[:S] for t in flip_reqs], dev, S, devices) for S in BUCKETS]
    domains = [{"replica": r, "device": str(srv.devices[r]), "clock_s": a.now_s, "energy_j": a.compute_energy_j,
                "op_switches": a.op_switches, "switch_time_s": a.switch_time_s}
               for r, a in enumerate(srv.arbiters)]
    current = check_current_device(cards)
    runs = {"flat": [], "sharded": []}
    for which in ("flat", "sharded", "sharded", "flat"):
        runs[which].append(timed_drain(fresh if which == "flat" else sharded, reqs))
    drains = {}
    for which, rs in runs.items():
        wall = float(np.median([r["wall_ms"] for r in rs]))
        busy = float(np.median([r["busy_ms"] for r in rs]))
        drains[which] = {"wall_ms": [r["wall_ms"] for r in rs], "busy_ms": [r["busy_ms"] for r in rs],
                         "wall_ms_median": wall, "busy_ms_median": busy, "device_idle_share": 1.0 - busy / wall,
                         "requests_per_s": n / (wall / 1e3), "device_ms_by_kernel": rs[0]["device_ms_by_kernel"]}
    result = {
        "phase": "sharded", "config": cfg.name, "devices": devices, "cards": cards,
        "note": None if cards >= R else f"one card: both replicas on cuda:0 ({cards} card present)",
        "replicas": R, "lanes_per_replica": L, "requests": n, "contracts": 2 * R, "placement": placement,
        "buckets": list(BUCKETS), "threshold": ctx["threshold"], "exit_layers": exits,
        "exits_equal_unsharded": True, "logits_max_abs_err_vs_unsharded": err, "tolerance": FULL_WIDTH_ATOL,
        "shard_flips": flips, "builds_per_bucket_replica": builds, "launches": launches,
        "accepted": tel["accepted"], "accepted_slo_misses": tel["accepted_slo_misses"],
        "deadline_misses": tel["deadline_misses"], "fused_steps": tel["dense_steps"],
        "avg_exit_layer": tel["avg_exit_layer"], "domains": domains, "op_switches": tel["op_switches"],
        "modeled_energy_j": tel["energy_j"], "current_device_checks": current, "drains": drains,
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
# phase 7b: the encoder family (ModernBERT-large) at full width and depth
# ---------------------------------------------------------------------------

# 16 lanes over buckets 2048 / 4096 / 8192, 24 seeded documents of 6144-8192
# tokens (all in bucket 8192: 8 refill lanes as the first exit, so the
# lanes run at mixed depths)
ENCODER_LANES = 16
ENCODER_BUCKETS = (2048, 4096, 8192)
ENCODER_DOCS = 24
ENCODER_LENGTHS = (6144, 8192)
# the kernel route against the plain route on the card, activation
# quantization off (nothing can flip): entropies and exit logits, 28
# layers of float32 sums in other orders
ENCODER_ATOL = 1e-4


def check_encoder_kernels(model, params, dev) -> list:
    """The encoder step's kernels at the shapes it gives them, each against
    its plain version: span attention through ``dispatch.dense_attention``
    (the route ``encoder_layer_step`` takes) at [16, 8192, 16, 64] with
    per-lane kv_len, at the global layers' window (None: every key; the
    long-row kernel, and beside it the short-row kernel forced at the same
    call, each with its registers and shared memory) and the local layers'
    65 (|i - j| <= 64), and the global window at bucket 2048 (both kernels:
    the long kernel's threshold); block_sparse on layer 0's pruned
    ``w_up`` [1024, 5248] and ``w_down`` [2624, 1024] at M = g x 8192; the
    scale-only LayerNorm (eps 1e-5) and af_quantize (one group of 8192 rows
    per lane) at [g x 8192, 1024]; g = 1 and 16, a group of one lane and of
    every lane.  Each row gives its error, tolerance, device time (queued)
    and bound; the plain span attention runs one lane at a time."""
    import numpy as np
    import torch

    from portbench.encoder_work import visible_pairs
    from repro_torch.kernels import block_sparse, build, dispatch, ref
    from repro_torch.kernels import span_attention as span_k
    from repro_torch.kernels.adaptivfloat_k import group_exp_bias, quantize_groups

    cfg = model.cfg
    S, H, hd, d = max(ENCODER_BUCKETS), cfg.n_heads, cfg.head_dim, cfg.d_model
    B = ENCODER_LANES
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []

    def row(name, shape, err, tol, ok, n_bytes, flops, fn, **detail):
        b_ms, b_by = bound_ms(n_bytes, flops, TC_PASSES.get(name, 0))
        r = {"phase": "encoder_kernel", "name": name, "shape": shape, "max_abs_err": err, "tolerance": tol,
             "ms": time_ms(fn, iters=5), "device_ms": time_ms(fn, iters=5, queued=True),
             "bound_ms": b_ms, "bound_by": b_by, **detail}
        emit(r)
        rows.append(r)
        if not ok:
            raise AssertionError(f"encoder {name} ({shape}): kernel and plain version disagree beyond {tol} "
                                 f"(max abs error {err})")
        return r

    # the span kernels' registers and shared memory (nvcc's report; the long
    # kernel's dynamic shared memory from its launcher)
    res = build.resources(["span_attention", "span_attention_long"])
    kernel_res = {route: {"functions": {f: r for f, r in res[lib]["functions"].items() if key in f},
                          "dynamic_smem": res[lib].get("dynamic_smem")}
                  for route, lib, key in (("short", "span_attention", "span_attention_kernelILi64EE"),
                                          ("long", "span_attention_long", "span_attention_kernel_"))}

    def short_route(q, k, v, lens, window):
        """The short-row kernel on the call ``dense_attention`` makes, where
        ``long_rows`` would pick the long one: the comparison at one shape."""
        Bq, Sq, Hq, d_ = q.shape
        out = torch.empty_like(q)
        span_k._launch(out.permute(0, 2, 1, 3), *(t.permute(0, 2, 1, 3) for t in (q, k, v)), None,
                       span_k._per_row(lens, Bq, Hq, False, "kv_lens"), Bq, Hq, Sq, k.shape[1], d_, window, 0,
                       short_only=True)
        return out

    def span_rows(S, kinds):
        q, k, v = (torch.randn(B, S, H, hd, generator=g, device=dev) for _ in range(3))
        lens_np = np.random.default_rng(S).integers(1, S + 1, B).astype(np.int32)
        lens_np[:2] = (S, 5)
        lens = torch.as_tensor(lens_np, device=dev)
        for window, kind in kinds:
            w = window or S
            routes = [("long" if span_k.long_rows(hd, False, False, w, S, S) else "short",
                       lambda: dispatch.dense_attention(q, k, v, causal=False, kv_len=lens, window=window))]
            if routes[0][0] == "long":
                routes.append(("short", lambda: short_route(q, k, v, lens, w)))
            pairs = sum(visible_pairs(S, int(kv), w - 1 if window else -1) for kv in lens_np)
            device_ms = {}
            for route, fn in routes:
                n_long = span_k.span_attention.long_launches
                got = fn()
                if span_k.span_attention.long_launches - n_long != int(route == "long"):
                    raise AssertionError(f"encoder span_attention {kind} S={S}: the {route} route "
                                         "took the other kernel")
                err = 0.0
                with torch.no_grad():
                    for b in range(B):
                        want = ref.span_attention(*(t[b:b + 1].permute(0, 2, 1, 3) for t in (q, k, v)),
                                                  torch.full((H,), w, dtype=torch.int32, device=dev),
                                                  causal=False, kv_lens=lens[b:b + 1, None].expand(-1, H))
                        err = max(err, (got[b:b + 1].permute(0, 2, 1, 3) - want).abs().max().item())
                        del want
                del got
                r = row("span_attention", f"{kind}: B={B}, S={S}, H={H}, dh={hd}, window={w}, kv_lens in "
                        f"[5, {S}], [B, S, H, dh], {route}-row kernel", err, "atol 2e-5", err <= 2e-5,
                        (2 * B * H * S * hd + 2 * H * hd * int(lens_np.sum())) * 4 + B * 4, 4.0 * hd * H * pairs,
                        fn, visible_pairs=pairs, kv_lens=lens_np.tolist(), route=route,
                        resources=kernel_res[route])
                device_ms[route] = r["device_ms"]
            if len(device_ms) == 2:
                emit({"phase": "encoder_span_routes", "kind": kind, "S": S, "device_ms": device_ms,
                      "long_speedup": device_ms["short"] / device_ms["long"]})
        del q, k, v
        torch.cuda.empty_cache()

    span_rows(S, ((None, "global"), (cfg.local_window // 2 + 1, "local")))
    # the long kernel's least rows: the global layers at bucket 2048
    span_rows(min(ENCODER_BUCKETS), ((None, "global"),))

    lp = model._layer(params, 0)[0]
    masks = dispatch.mlp_block_masks(lp["mlp"])
    scale = lp["mlp_norm"]["scale"] + 0.1 * torch.randn(d, generator=g, device=dev)
    zero = torch.zeros(d, device=dev)
    for lanes in (1, B):
        M = lanes * S
        for name in ("w_up", "w_down"):
            w, m = lp["mlp"][name], masks[name]
            K, N = w.shape
            x = torch.randn(M, K, generator=g, device=dev)
            got = block_sparse.block_sparse_matmul(x, w, m)
            want = ref.block_sparse_matmul(x, w, m.mask, m.bk, m.bn)
            err, ok = (got - want).abs().max().item(), torch.allclose(got, want, rtol=1e-5, atol=1e-5)
            tiles = m.occupied
            row("block_sparse_matmul", f"{name}: M={M} ({lanes} x {S}), {K}x{N} ({tiles}/{m.mask.size} tiles)",
                err, "rtol 1e-5 + atol 1e-5", ok,
                M * K * 4 + tiles * m.bk * m.bn * 4 + m.indices.numel() * 4 + M * N * 4,
                2.0 * M * tiles * m.bk * m.bn, lambda: block_sparse.block_sparse_matmul(x, w, m))
            del x, got, want
        x = torch.randn(M, d, generator=g, device=dev) * 3.0
        err = (dispatch.layernorm(x, scale, zero, eps=cfg.norm_eps)
               - ref.layernorm(x, scale, zero, eps=cfg.norm_eps)).abs().max().item()
        row("layernorm", f"[{M}, {d}] fp32 ({lanes} x {S}), scale only, eps {cfg.norm_eps}", err, "atol 1e-5",
            err <= 1e-5, (2 * M * d + 2 * d) * 4, 8.0 * M * d,
            lambda: dispatch.layernorm(x, scale, zero, eps=cfg.norm_eps))
        x[: S // 2] *= 1e-3
        e_cpu = group_exp_bias(x.cpu(), S)
        qx, e_min = quantize_groups(x, S)
        err = (qx.cpu() - ref.quantize(x.cpu(), e_cpu, S)).abs().max().item()
        row("af_quantize", f"[{M}, {d}] fp32, {lanes} row group{'s' if lanes > 1 else ''} of {S}", err,
            "atol 0 and equal biases (against the CPU plain version)",
            err == 0.0 and torch.equal(e_min.cpu(), e_cpu), 2 * M * d * 4 + lanes * 4, 20.0 * M * d,
            lambda: quantize_groups(x, S))
        del x, qx
    torch.cuda.empty_cache()
    return rows


def encoder_drain(model, params, docs, dev, threshold, **kw):
    """One ClassifierServer drain of ``docs`` (ENCODER_LANES lanes,
    ENCODER_BUCKETS) at ``threshold``; returns (server, wall seconds)."""
    import dataclasses

    import torch

    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ClassifierServer

    cfg = model.cfg.with_edgebert(early_exit=dataclasses.replace(model.cfg.edgebert.early_exit,
                                                                 entropy_threshold=threshold))
    srv = ClassifierServer(build_model(cfg), params, batch_lanes=ENCODER_LANES, buckets=ENCODER_BUCKETS,
                           device=dev, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    serve(srv, docs)
    torch.cuda.synchronize()
    return srv, time.perf_counter() - t


def run_encoder_path(dev) -> dict:
    """ModernBERT-large (28 unshared layers, d 1024, windows 65 and 8192)
    served through ClassifierServer on the card, each lane at its own
    layer: the weights drawn on the card from seed 0 with every layer's MLP
    pruned to 0.5 in 32 x 32 tiles; the step's kernels at its shapes
    (``check_encoder_kernels``); then, activation quantization off, a
    full-depth drain of the documents for the threshold (about half exit
    early) and the kernel route against the plain route at it: exits equal
    (but where an entropy lies within ENCODER_ATOL of the threshold),
    entropy traces and exit logits within ENCODER_ATOL; then the deployed
    stack (AF(8, 3) after every layer, a shared-clock arbiter over the mean
    of the global and local layers) with the launch counts zeroed just
    before the drain: one layer call per depth group, layernorm twice a
    group (once at layer 0: its attention norm is the identity),
    af_quantize and span_attention once, block_sparse_matmul twice, nothing
    else (the off-ramp runs on the reference ops), matched against the
    engine's layer log step by step, and the long-row span kernel once per
    global-layer group; more groups than steps."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.early_exit import fit_exit_predictor
    from repro_torch.core.pruning import magnitude_mask
    from repro_torch.hwmodel.edgebert_accel import modernbert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.kernels.span_attention import span_attention
    from repro_torch.models.model import build_model, init_params
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, default_albert_controller, no_early_exit_baseline
    from repro_torch.serving.engine import ClassifierServer

    seconds, t = {}, time.perf_counter()

    def lap(name):
        nonlocal t
        seconds[name] = time.perf_counter() - t
        t = time.perf_counter()

    cfg = get_config("modernbert_large")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    mlp = params["layers"]["mlp"]
    with torch.no_grad():
        for name in ("w_up", "w_down"):
            for i in range(cfg.n_layers):
                mlp[name][i] *= magnitude_mask(mlp[name][i], cfg.edgebert.prune.encoder_sparsity, block_size=32)
    model = build_model(cfg)
    emit({"phase": "encoder_weights", "config": cfg.name, "params": sum(t_.numel() for t_ in leaves(params)),
          "gb": n_bytes(params) / 1e9})
    lap("weights")
    kernel_rows = check_encoder_kernels(model, params, dev)
    lap("kernels")

    r = np.random.default_rng(0)
    docs = [r.integers(3, cfg.vocab_size, int(n)).astype(np.int32)
            for n in r.integers(ENCODER_LENGTHS[0], ENCODER_LENGTHS[1] + 1, ENCODER_DOCS)]
    plain_model = build_model(cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, enabled=False)))
    full, _ = encoder_drain(plain_model, params, docs, dev, 0.0)
    traces = np.asarray([full.done[i].entropy_trace for i in range(len(docs))], np.float64)
    thr = pick_threshold(traces)
    lap("profile")
    routes = {k: encoder_drain(plain_model, params, docs, dev, thr, use_kernels=k == "kernel")
              for k in ("kernel", "plain")}
    lap("routes")
    (kern, kern_s), (plain, plain_s) = routes["kernel"], routes["plain"]
    ent_err = lg_err = 0.0
    mismatched, excused = [], []
    for i in range(len(docs)):
        a, b = kern.done[i], plain.done[i]
        n = min(len(a.entropy_trace), len(b.entropy_trace))
        ta, tb = np.asarray(a.entropy_trace[:n]), np.asarray(b.entropy_trace[:n])
        ent_err = max(ent_err, float(np.abs(ta - tb).max()))
        if a.exit_layer == b.exit_layer:
            lg_err = max(lg_err, float(np.abs(np.asarray(a.result) - np.asarray(b.result)).max()))
        else:
            (excused if np.abs(tb - thr).min() < ENCODER_ATOL else mismatched).append(i)
    routes_line = {"phase": "encoder_routes", "threshold": thr, "documents": len(docs),
                   "exits": [kern.done[i].exit_layer for i in range(len(docs))],
                   "entropy_max_abs_err": ent_err, "exit_logits_max_abs_err": lg_err, "atol": ENCODER_ATOL,
                   "exit_mismatches": mismatched, "exit_mismatches_at_threshold": excused,
                   "kernel_drain_s": kern_s, "plain_drain_s": plain_s}
    emit(routes_line)
    if mismatched or ent_err > ENCODER_ATOL or lg_err > ENCODER_ATOL:
        raise AssertionError(f"encoder: the kernel route and the plain route differ: {routes_line}")

    S = max(ENCODER_BUCKETS)
    stats = modernbert_layer_stats(seq_len=S, d=cfg.d_model, ff=cfg.d_ff, heads=cfg.n_heads, n_layers=cfg.n_layers,
                                   global_every=cfg.global_every, local_span=cfg.local_window)
    below = np.concatenate([traces[:, :-1] < thr, np.ones((len(docs), 1), bool)], axis=1)
    ctrl = default_albert_controller(no_early_exit_baseline(stats)["latency_s"], seq_len=S, n_layers=cfg.n_layers,
                                     predictor=fit_exit_predictor(traces[:, 0], np.argmax(below, axis=1) + 1,
                                                                  n_bins=8), stats=stats)
    dep_cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit, entropy_threshold=thr))
    srv = ClassifierServer(build_model(dep_cfg), params, batch_lanes=ENCODER_LANES, buckets=ENCODER_BUCKETS,
                           device=dev, arbiter=BatchedDVFSArbiter(ctrl))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    n_long = span_attention.long_launches
    t0 = time.perf_counter()
    serve(srv, docs)
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    long_launches = span_attention.long_launches - n_long
    lap("deployed")
    tel = srv.telemetry()
    groups = [sorted({int(x) for x in layers if x >= 0}) for _, layers in srv.layer_log]
    n_groups = sum(len(gs) for gs in groups)
    # every group at a global layer runs its attention on the long-row kernel
    # (documents of 6144-8192 tokens: bucket 8192), every local one on the
    # short-row kernel
    n_global = sum(1 for gs in groups for layer in gs if model.is_global(layer))
    want = {k: 0 for k in launches}
    want.update(span_attention=n_groups, af_quantize=n_groups, block_sparse_matmul=2 * n_groups,
                layernorm=sum(1 if layer == 0 else 2 for gs in groups for layer in gs))
    exits = [srv.done[i].exit_layer for i in range(len(docs))]
    result = {
        "phase": "encoder", "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "lanes": ENCODER_LANES, "buckets": ENCODER_BUCKETS, "documents": len(docs),
        "lengths": [len(x) for x in docs], "threshold": thr, "exits": exits,
        "exit_layer_counts": {int(e): int(c) for e, c in zip(*np.unique(exits, return_counts=True))},
        "launches": launches, "launches_want": want, "span_long_launches": long_launches,
        "global_groups": n_global, "steps": len(groups), "depth_groups": n_groups,
        "max_groups_per_step": max(len(gs) for gs in groups),
        "telemetry": {k: tel[k] for k in ("dense_steps", "depth_groups", "layer_calls", "lane_layers_global",
                                          "lane_layers_local", "host_syncs")},
        "drain_s": drain_s, "documents_per_s": len(docs) / drain_s,
        "drain_peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "kernel_rows": len(kernel_rows), "seconds": seconds,
    }
    emit(result)
    if launches != want:
        raise AssertionError(f"encoder: launches {launches}, want {want} from the layer log")
    if long_launches != n_global or n_global == 0:
        raise AssertionError(f"encoder: {long_launches} long-row span launches, want the layer log's "
                             f"{n_global} global groups")
    if not (tel["depth_groups"] == n_groups and tel["dense_steps"] == len(groups) and n_groups > len(groups)
            and tel["lane_layers_global"] + tel["lane_layers_local"] == tel["layer_calls"]):
        raise AssertionError(f"encoder: telemetry {result['telemetry']} against the layer log "
                             f"({len(groups)} steps, {n_groups} groups)")
    if not all(1 <= e <= cfg.n_layers for e in exits) or len(set(exits)) < 3:
        raise AssertionError(f"encoder: exits {exits}")
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


# the phase of each decoder that run_decode_path drives
DECODE_PHASES = {"deepseek_7b": "decode", "qwen2_moe_a2p7b": "moe_decode", "minitron_8b": "ln_decode"}
# depth cuts for the script's time, at full width: deepseek-7b's decode
# phase runs its first 10 of 30 layers (with the hybrid and encdec phases
# the whole script took 544 s of its 600 s aim at full depth), minitron-8b's
# ln_decode its first 16 of 32 (the dist_train and bf16_decode phases
# added ~60 s: the phases summed to 613.9 s with ln_decode's 88.9 s at full
# depth), and
# qwen2-moe-a2.7b's moe_decode its first 8 of 24 (the vlm_decode and
# lm_train phases and the served whisper drains added ~89 s to the 521 s
# the script took with the first cut, and the decode phase's eb_decode
# ~27 s: the phases summed to 597 s with 12 layers; moe_decode took 108 s
# at full depth, 70 s at 12)
DECODE_DEPTH = {"deepseek_7b": 10, "qwen2_moe_a2p7b": 8, "minitron_8b": 16}


def draw_decoder(cfg, phase, dev):
    """The decoder's float32 weights drawn on the card from seed 0, after
    the previous phase's are released and the free memory is checked
    (qkv biases drawn nonzero from the same generator, where the config has
    them: the init zeroes them, as the JAX package's does).  Emits the
    ``{phase}_weights`` line; returns (params, that line)."""
    import gc

    import torch

    from repro_torch.models.model import init_params

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
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            params["layers"]["attn"][name].normal_(generator=gen).mul_(0.5)
    torch.cuda.synchronize()
    line = {"phase": f"{phase}_weights", "config": cfg.name, "params": sum(t.numel() for t in leaves(params)),
            "bytes": n_bytes(params), "mem_free_gb_before_draw": free_before / 1e9,
            "mem_free_gb_after_draw": torch.cuda.mem_get_info()[0] / 1e9, "init_s": time.perf_counter() - t0}
    emit(line)
    return params, line


def run_decode_path(dev, arch: str = "deepseek_7b") -> dict:
    """A decoder at full width (and depth, but for DECODE_DEPTH's cut),
    float32 weights drawn on the card from seed 0, through the
    DecoderServer: deepseek-7b (the ``decode`` phase: its first 10 of 30
    layers, d_model 4096, 32 x 128 heads, d_ff 11008, vocab 102400),
    qwen2-moe-a2.7b (``moe_decode``: its first 8 of 24 layers, d_model 2048,
    16 x 128 heads, 60 experts of d_ff 1408 top-4 and a shared expert of
    5632, qkv biases drawn nonzero from the same generator, vocab 151936)
    or minitron-8b (``ln_decode``: its first 16 of 32 layers, d_model 4096, 32 x 128 query
    heads over 8 KV heads, LayerNorm, a squared-ReLU MLP of d_ff 16384,
    vocab 256000); the free device memory is checked before the draw.  The recipe of the
    JAX package's examples/serve_multitask.py decoder lane:
    probe_exit_threshold (median of first-off-ramp entropies at full
    depth), then a drain with per-token exit and a shared-clock arbiter at
    spec_window 1, then the same traffic at spec_window 4 with an
    ExitThresholdSchedule.  Checks the kernels' launches (softmax_entropy
    n_layers x W per fused step; for the LayerNorm decoder layernorm
    3 n_layers x W per fused step and 2 n_layers + 1 per prefill token;
    every kernel of the family's list), W = 4's accepted tokens, exit depths and final logits equal to W = 1's bit
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
    from repro_torch.models.model import build_model
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController, no_early_exit_baseline
    from repro_torch.serving import step_math
    from repro_torch.serving.engine import DecoderServer, probe_exit_threshold

    full_depth = get_config(arch).n_layers
    cfg = dataclasses.replace(get_config(arch), dtype="float32", remat_policy="none",
                              n_layers=DECODE_DEPTH.get(arch, full_depth))
    phase = DECODE_PHASES[arch]
    kernels = (ops.MOE_DECODE_KERNELS if cfg.family == "moe" else
               ops.LN_DECODE_KERNELS if cfg.norm == "layernorm" else ops.DECODE_KERNELS)
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    n_params, init_s = drawn["params"], drawn["init_s"]
    free_before, free_after = drawn["mem_free_gb_before_draw"], drawn["mem_free_gb_after_draw"]
    prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    n, W4 = DECODE_REQUESTS, DECODE_SPEC_WINDOW
    # the serving prefill steps each prompt but its last token, one decode
    # step per token; a LayerNorm decoder's step launches layernorm for both
    # pre-norms of every layer and the final norm
    prefill_tokens = n * (DECODE_PROMPT - 1)
    ln_per_prefill_token = 2 * cfg.n_layers + 1 if cfg.norm == "layernorm" else 0

    t0 = time.perf_counter()
    thr = probe_exit_threshold(model, params, prompts, batch_lanes=DECODE_LANES, max_seq=DECODE_BUCKET,
                               buckets=(DECODE_BUCKET,), max_new_tokens=DECODE_NEW, device=dev)
    probe_s = time.perf_counter() - t0
    stats = albert_layer_stats(seq_len=DECODE_BUCKET)
    stats.n_layers = cfg.n_layers
    target = no_early_exit_baseline(stats)["latency_s"] * 2.0

    def fresh(W, lanes=DECODE_LANES, **kw):
        arb = BatchedDVFSArbiter(LatencyAwareDVFSController(stats, target))
        return DecoderServer(model, params, batch_lanes=lanes, max_seq=DECODE_BUCKET, eos_id=-1,
                             buckets=(DECODE_BUCKET,), arbiter=arb, exit_threshold=thr, spec_window=W,
                             threshold_schedule=ExitThresholdSchedule(thr) if W > 1 else None, device=dev, **kw)

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
        want_ln = 3 * cfg.n_layers * W * steps + ln_per_prefill_token * prefill_tokens if ln_per_prefill_token else 0
        if launches["layernorm"] != want_ln:
            raise AssertionError(f"{phase} W={W}: layernorm launched {launches['layernorm']} times, want "
                                 f"3 n_layers x W x fused steps + (2 n_layers + 1) x prefill tokens = {want_ln}")
        if any(launches[k] for k in launches if k not in kernels):
            raise AssertionError(f"{phase} W={W}: kernels off the path launched: {launches}")
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
            "layernorm_launches_per_fused_step": (launches["layernorm"] - ln_per_prefill_token * prefill_tokens)
            / steps, "layernorm_launches_per_prefill_token": ln_per_prefill_token,
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
    sharded = (sharded_decode(fresh, servers, {W: d["drain_ms"] for W, d in drains.items()}, prompts, cfg, phase)
               if arch == "deepseek_7b" else None)

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

    parts = profile_parts((("fused_step", fused_steps, DECODE_STEPS), ("prefill", prefill, 1)))
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
    eb = run_eb_decode_path(dev, cfg, params, prompts, drains, parts) if arch == "deepseek_7b" else None
    result = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers, "depth_cut_from": full_depth,
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "act": cfg.act, "norm": cfg.norm,
        "n_experts": cfg.n_experts, "top_k": cfg.top_k, "moe_d_ff": cfg.moe_d_ff,
        "shared_expert_d_ff": cfg.shared_expert_d_ff, "qkv_bias": cfg.qkv_bias,
        "dtype": cfg.dtype, "params": n_params, "init_s": init_s,
        "mem_free_gb_before_draw": free_before, "mem_free_gb_after_draw": free_after,
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "requests": n, "prompt_tokens": DECODE_PROMPT, "max_new_tokens": DECODE_NEW, "lanes": DECODE_LANES,
        "bucket": DECODE_BUCKET, "threshold": thr, "probe_s": probe_s,
        "target_latency_s": target, "drains": {f"W={W}": d for W, d in drains.items()},
        "spec_equals_per_token": True, "parts": parts,
        "fused_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()},
        "fused_step_hbm_bound_ms": step_bound_ms, "launches": drains[1]["launches"],
        "reference": {k: ref[k] for k in ("offramp_logits_max_abs_err", "offramp_entropy_max_abs_err",
                                           "boundary_tokens_excused", "compared_tokens")},
        "sharded": sharded,
    }
    emit(result)
    result["eb_decode"] = eb
    del params, servers, a, b, srv, cache, layers
    gc.collect()
    torch.cuda.empty_cache()
    return result


def sharded_decode(fresh, flat, flat_ms, prompts, cfg, phase) -> dict:
    """The decode phase's traffic through a DecoderServer of 2 replicas x
    2 lanes (``sharded_devices``) at the probe's threshold, spec windows 1
    and 4, against the phase's unsharded 4-lane drains (``flat``: {W:
    server}, their drain ms ``flat_ms``): every request's generated tokens and exit depths equal to the
    unsharded drain's, W = 4 equal to W = 1 bit for bit (tokens, exits,
    final logits), softmax_entropy's wide-row entry launched R x n_layers x
    W times per fused step (each slab runs its own LM-head entropies) and
    no kernel off SHARDED_DECODE_KERNELS, one decode build per (bucket, 2),
    the current device unchanged.  Drain wall ms and tokens/s beside the
    unsharded drain's; the final logits' largest difference from the
    unsharded drain's is reported (a slab's GEMVs run at half the rows)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    devices, cards = sharded_devices()
    R = SHARDED_REPLICAS
    n, W4 = DECODE_REQUESTS, DECODE_SPEC_WINDOW
    start_dev = torch.cuda.current_device()
    out, servers = {"devices": devices, "cards": cards, "replicas": R, "lanes_per_replica": DECODE_LANES // R,
                    "drains": {}}, {}
    for W in (1, W4):
        srv = fresh(W, lanes=DECODE_LANES // R, replicas=R, devices=devices)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        serve(srv, prompts, max_new_tokens=DECODE_NEW)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        tel = srv.telemetry()
        steps = tel["decode_steps"]
        want = R * cfg.n_layers * W * steps
        if launches["softmax_entropy"] != want or any(launches[k] for k in launches
                                                      if k not in ops.SHARDED_DECODE_KERNELS):
            raise AssertionError(f"{phase} sharded W={W}: launches {launches}, want softmax_entropy "
                                 f"R x n_layers x W x fused steps = {want} and nothing else")
        if tel["step_traces_per_bucket_replica"] != {f"{DECODE_BUCKET}x{R}": 1}:
            raise AssertionError(f"{phase} sharded W={W}: builds {tel['step_traces_per_bucket_replica']}")
        if torch.cuda.current_device() != start_dev:
            raise AssertionError(f"{phase} sharded W={W}: the current device moved")
        ref = flat[W]
        for i in range(n):
            if (srv.done[i].generated != ref.done[i].generated
                    or srv.done[i].token_exit_layers != ref.done[i].token_exit_layers):
                raise AssertionError(f"{phase} sharded W={W} request {i}: tokens {srv.done[i].generated} / exits "
                                     f"{srv.done[i].token_exit_layers} differ from the unsharded drain's "
                                     f"{ref.done[i].generated} / {ref.done[i].token_exit_layers}")
        servers[W] = srv
        out["drains"][f"W={W}"] = {
            "drain_ms": wall, "tokens": tel["tokens"], "tokens_per_s": tel["tokens"] / (wall / 1e3),
            "fused_steps": steps, "launches": launches,
            "softmax_entropy_launches_per_fused_step": launches["softmax_entropy"] / steps,
            "unsharded_drain_ms": flat_ms[W], "tokens_equal_unsharded": True,
            "logits_max_abs_err_vs_unsharded": max(float(np.abs(srv.done[i].result - ref.done[i].result).max())
                                                   for i in range(n)),
            "modeled_energy_j": tel["energy_j"], "accepted_slo_misses": tel["accepted_slo_misses"],
            "domains": [{"replica": r, "clock_s": a.now_s, "energy_j": a.compute_energy_j,
                         "op_switches": a.op_switches} for r, a in enumerate(srv.arbiters)],
        }
    a, b = servers[1], servers[W4]
    for i in range(n):
        if (a.done[i].generated != b.done[i].generated or a.done[i].token_exit_layers != b.done[i].token_exit_layers
                or not np.array_equal(a.done[i].result, b.done[i].result)):
            raise AssertionError(f"{phase} sharded request {i}: spec_window {W4} differs from spec_window 1")
    out["spec_equals_per_token"] = True
    out["launches"] = out["drains"]["W=1"]["launches"]
    return out


# ---------------------------------------------------------------------------
# phase 8a (continued): EdgeBERT's features on the dense decoder (eb_decode)
# ---------------------------------------------------------------------------

# span_z drawn from the seed in [0, EB_SPAN_MAX]: at the init's 64 with a
# 32-token ramp no head's mask would fall below 1 within a 24-token request
EB_SPAN_MAX = 8.0
EB_REF_LAYERS = 2


def check_eb_decode_reference(cfg, params, seq, dev) -> dict:
    """The card against the CPU on the first EB_REF_LAYERS layers of the
    eb_decode model, teacher-forced: one lane through ``seq`` one token at
    a time; at every (token, layer) both sides run the layer before its
    activation quantization (the spans on, cache attention on the
    reference ops) from the CPU's hidden state and the CPU's KV rows, then
    ``quantize_groups`` (the kernel on the card, its plain version on the
    CPU), and the CPU's quantized output goes on.  The pre-quantization
    outputs must agree within DECODE_ATOL with equal biases, and every
    quantized element that differs must be one AF grid step at a rounding
    boundary (``flip_check``)."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.core.adaptivfloat import AFFormat
    from repro_torch.kernels.adaptivfloat_k import quantize_groups
    from repro_torch.models.model import build_model

    L_ = EB_REF_LAYERS
    q = cfg.edgebert.quant
    fmt = AFFormat(q.n_bits, q.n_exp)
    model = build_model(dataclasses.replace(cfg, n_layers=L_).with_edgebert(
        quant=dataclasses.replace(q, quantize_activations=False)))
    cpu = torch.device("cpu")
    card = {"layers": cut_layers(params["layers"], L_), "span_z": params["span_z"][:L_]}
    host = tree_to(card, cpu)
    caches = {"card": model.init_cache(1, DECODE_BUCKET, device=dev),
              "cpu": model.init_cache(1, DECODE_BUCKET, device=cpu)}
    t0 = time.perf_counter()
    per_layer = [{"layer": i + 1, "flips": 0, "elements": 0, "pre_quant_max_abs_err": 0.0, "flip_max_abs": 0.0,
                  "biases_equal": True, "all_one_step": True, "all_at_boundary": True} for i in range(L_)]
    with torch.no_grad():
        for t, tok in enumerate(seq):
            h = model.embed(params, torch.tensor([[tok]], device=dev)).cpu()
            for i in range(L_):
                for name in ("k", "v"):
                    caches["card"][name][i].copy_(caches["cpu"][name][i])
                sides = []
                for side, p, d in (("cpu", host, cpu), ("card", card, dev)):
                    c = caches[side]
                    pos = torch.tensor([t], device=d)
                    pre = model._dense_layer_step(model._layer(p, i)[0], h.to(d), causal=True,
                                                  positions=pos[:, None], span_z=p["span_z"][i],
                                                  cache=(c["k"][i], c["v"][i]), cache_pos=pos, use_kernels=True,
                                                  per_lane=True)
                    qd, ed = quantize_groups(pre.reshape(1, -1).contiguous(), 1, fmt=fmt)
                    sides.append((pre.cpu(), qd.reshape(pre.shape).cpu(), ed.cpu()))
                r, acc = flip_check(sides[0], sides[1], fmt), per_layer[i]
                for k in ("flips", "elements"):
                    acc[k] += r[k]
                for k in ("pre_quant_max_abs_err", "flip_max_abs"):
                    acc[k] = max(acc[k], r[k])
                for k in ("biases_equal", "all_one_step", "all_at_boundary"):
                    acc[k] = acc[k] and r[k]
                h = sides[0][1]
    result = {"phase": "eb_reference", "config": f"{cfg.name} first {L_} layers (cut from {cfg.n_layers}), "
              "AF(8,3) activations, spans", "teacher_forced_tokens": len(seq),
              "pre_quant_atol": DECODE_ATOL, "flips": sum(r["flips"] for r in per_layer),
              "elements": sum(r["elements"] for r in per_layer),
              "pre_quant_max_abs_err": max(r["pre_quant_max_abs_err"] for r in per_layer),
              "flip_max_abs": max(r["flip_max_abs"] for r in per_layer), "per_layer": per_layer,
              "seconds": time.perf_counter() - t0}
    emit(result)
    for r in per_layer:
        if not (r["pre_quant_max_abs_err"] <= DECODE_ATOL and r["biases_equal"]):
            raise AssertionError(f"eb_decode reference, layer {r['layer']}: the layer before quantization differs "
                                 f"beyond {DECODE_ATOL} or moves the bias: {r}")
        if not (r["all_one_step"] and r["all_at_boundary"]):
            raise AssertionError(f"eb_decode reference, layer {r['layer']}: a quantized element differs by more "
                                 f"than one grid step or away from an AF boundary: {r}")
    return result


def run_eb_decode_path(dev, cfg, params, prompts, decode_drains, decode_parts) -> dict:
    """The ``decode`` phase's deepseek-7b weights (its depth, drawn on the
    card) with EdgeBERT's features on: AF(8,3) activation quantization
    after every layer and adaptive spans, ``span_z`` [n_layers, n_heads]
    drawn from seed 1 in [0, EB_SPAN_MAX] (every head's soft mask falls
    below 1 within a request).  The decode recipe: probe_exit_threshold,
    then the 8 SyntheticLM requests through 4 lanes with per-token exit and
    an arbiter at spec windows 1 and 4.  Checks the launches
    (``ops.EB_DECODE_KERNELS`` only: af_quantize n_layers x W per fused step
    and n_layers per prefill token, softmax_entropy n_layers x W per fused
    step), W = 4 equal to W = 1 bit for bit, one decode and one prefill
    build per bucket, finite outputs; times the drains, a fused step and a
    prefill beside the decode phase's; then the first 2 layers against the
    CPU (``check_eb_decode_reference``)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import QuantConfig, SpanConfig
    from repro_torch.core.early_exit import ExitThresholdSchedule
    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import step_math
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController, no_early_exit_baseline
    from repro_torch.serving.engine import DecoderServer, probe_exit_threshold

    phase = "eb_decode"
    t_start = time.perf_counter()
    cfg = cfg.with_edgebert(quant=QuantConfig(enabled=True), span=SpanConfig(enabled=True))
    gen = torch.Generator(device=dev).manual_seed(1)
    params = dict(params, span_z=torch.rand((cfg.n_layers, cfg.n_heads), generator=gen, device=dev) * EB_SPAN_MAX)
    model = build_model(cfg)
    n, W4, L_ = DECODE_REQUESTS, DECODE_SPEC_WINDOW, cfg.n_layers
    prefill_tokens = n * (DECODE_PROMPT - 1)
    t0 = time.perf_counter()
    thr = probe_exit_threshold(model, params, prompts, batch_lanes=DECODE_LANES, max_seq=DECODE_BUCKET,
                               buckets=(DECODE_BUCKET,), max_new_tokens=DECODE_NEW, device=dev)
    probe_s = time.perf_counter() - t0
    stats = albert_layer_stats(seq_len=DECODE_BUCKET)
    stats.n_layers = L_
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
        want = {"softmax_entropy": L_ * W * steps, "af_quantize": L_ * W * steps + L_ * prefill_tokens}
        if {k: launches[k] for k in want} != want or any(launches[k] for k in launches if k not in want):
            raise AssertionError(f"{phase} W={W}: launches {launches}, want {want} (n_layers x W per fused step, "
                                 f"af_quantize also n_layers per prefill token) and nothing else")
        if tuple(sorted(want)) != tuple(sorted(ops.EB_DECODE_KERNELS)):
            raise AssertionError(f"{phase}: the path lists {ops.EB_DECODE_KERNELS}")
        if tel["decode_traces_per_bucket"] != {DECODE_BUCKET: 1} or tel["prefill_traces"] != 1:
            raise AssertionError(f"{phase} W={W}: builds per bucket: {tel}")
        results = np.stack([srv.done[i].result for i in range(n)])
        gen_toks = [srv.done[i].generated for i in range(n)]
        exits = [srv.done[i].token_exit_layers for i in range(n)]
        if not (np.isfinite(results).all() and results.shape == (n, cfg.vocab_size)):
            raise AssertionError(f"{phase} W={W}: decode logits are not finite or of the wrong shape")
        if any(len(g_) != DECODE_NEW or not all(0 <= t < cfg.vocab_size for t in g_) for g_ in gen_toks):
            raise AssertionError(f"{phase} W={W}: generated tokens off: {gen_toks}")
        if not all(1 <= x <= L_ for e in exits for x in e):
            raise AssertionError(f"{phase} W={W}: exit layers out of range: {exits}")
        servers[W] = srv
        drains[W] = {"spec_window": W, "drain_ms": wall, "decode_phase_drain_ms": decode_drains[W]["drain_ms"],
                     "tokens": tel["tokens"], "tokens_per_s": tel["tokens"] / (wall / 1e3), "fused_steps": steps,
                     "launches": launches, "af_quantize_launches_per_fused_step": L_ * W,
                     "af_quantize_launches_per_prefill_token": L_,
                     "avg_token_exit_layer": tel["avg_token_exit_layer"],
                     "tokens_per_fused_step": tel["tokens_per_fused_step"],
                     "modeled_energy_per_token_j": tel["energy_j"] / tel["tokens"],
                     "deadline_misses": tel["deadline_misses"], "generated": gen_toks, "token_exit_layers": exits}
    a, b = servers[1], servers[W4]
    for i in range(n):
        if (a.done[i].generated != b.done[i].generated
                or a.done[i].token_exit_layers != b.done[i].token_exit_layers
                or not np.array_equal(a.done[i].result, b.done[i].result)):
            raise AssertionError(f"{phase} request {i}: spec_window {W4} differs from spec_window 1")
    # a fused W = 1 step of the 4 lanes and one request's prefill, timed and
    # profiled alone as the decode phase's parts are
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

    parts = profile_parts((("fused_step", fused_steps, DECODE_STEPS), ("prefill", prefill, 1)))
    for name, part in parts.items():
        part["decode_phase_wall_ms"] = decode_parts[name]["wall_ms"]
        part["decode_phase_device_busy_ms"] = decode_parts[name]["device_busy_ms"]
    seq = [int(t) for t in prompts[0]] + [int(t) for t in prompts[1][:DECODE_NEW]]
    ref = check_eb_decode_reference(cfg, params, seq, dev)
    result = {
        "phase": phase, "config": f"{cfg.name}, AF({cfg.edgebert.quant.n_bits},{cfg.edgebert.quant.n_exp}) "
        f"activations, adaptive spans (span_z from seed 1 in [0, {EB_SPAN_MAX}], ramp {cfg.edgebert.span.ramp})",
        "n_layers": L_, "span_z_min_per_layer": [float(x) for x in params["span_z"].min(dim=1).values], "threshold": thr,
        "probe_s": probe_s, "requests": n, "lanes": DECODE_LANES, "bucket": DECODE_BUCKET,
        "drains": {f"W={W}": d for W, d in drains.items()}, "spec_equals_per_token": True, "parts": parts,
        "launches": drains[1]["launches"], "kernels": list(ops.EB_DECODE_KERNELS),
        "reference": {k: ref[k] for k in ("flips", "elements", "pre_quant_max_abs_err", "flip_max_abs")},
        "seconds": time.perf_counter() - t_start,
    }
    emit(result)
    return result


# ---------------------------------------------------------------------------
# phase 8d: the RWKV6 decoder (rwkv6-7b, the ssm family)
# ---------------------------------------------------------------------------


def stage_split(stages, lp_card, lp_cpu, env, dev, whole=None) -> dict:
    """One layer's card-against-CPU error, op by op.  ``stages`` is a list of
    (name, fn(env, lp) -> new tensors); ``env`` holds the layer's inputs on
    the CPU.  The CPU runs every stage; the card runs them from the same
    inputs in turn (`carried`: the error the card's own chain has reached
    after the stage) and each stage alone from the CPU's inputs (`local`:
    the error that stage adds by itself).  ``whole``, the CPU's output of
    the model's own layer step, must equal the stages' last output within
    1e-6 (the split computes what the model computes).  Returns {stage:
    {carried, local, max_abs}}, maxima over the stage's outputs."""
    import torch

    cpu = dict(env)
    outs = []
    for name, fn in stages:
        new = fn(cpu, lp_cpu)
        cpu.update(new)
        outs.append((name, fn, tuple(new)))
    card = {k: v.to(dev) for k, v in env.items()}
    cpu_on_card = {k: v.to(dev) for k, v in cpu.items()}
    split = {}
    for name, fn, keys in outs:
        card.update(fn(card, lp_card))
        local = fn(cpu_on_card, lp_card)
        split[name] = {
            "carried_max_abs_err": max((card[k].cpu() - cpu[k]).abs().max().item() for k in keys),
            "local_max_abs_err": max((local[k].cpu() - cpu[k]).abs().max().item() for k in keys),
            "max_abs": max(cpu[k].abs().max().item() for k in keys),
        }
    if whole is not None:
        last = cpu[outs[-1][2][0]]
        if not torch.allclose(last, whole, rtol=0, atol=1e-6):
            raise AssertionError(f"the op split does not compute the layer step: {(last - whole).abs().max()}")
    return split


def rwkv_layer_stages(cfg) -> list:
    """One RWKV6 layer's decode step (``Model._rwkv_layer_step`` with
    ``decode=True``, one token) as named stages, op for op as
    ``models/rwkv6.py`` computes it.  Inputs: h [B, 1, d], last_tm,
    last_cm, wkv."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import rwkv6

    H, K, d = cfg.n_heads, cfg.head_dim, cfg.d_model

    def norm1(e, lp):
        return {"x": L.apply_norm(lp["norm1"], e["h"])}

    def shift_and_loras(e, lp):
        p, x = lp["tmix"], e["x"]
        B, S, _ = x.shape
        x_prev = rwkv6._token_shift(x, e["last_tm"])
        lora = torch.tanh((x @ p["ts_lora_a"]).float()) @ p["ts_lora_b"].float()
        mix = torch.sigmoid(p["mix_rkvg"].float()[None, None] + lora.reshape(B, S, 4, d)).to(x.dtype)
        return dict(zip(("xr", "xk", "xv", "xg"), (x * mix[:, :, i] + x_prev * (1 - mix[:, :, i]) for i in range(4))))

    def projections(e, lp):
        p = lp["tmix"]
        B, S, _ = e["xr"].shape
        return {"r": (e["xr"] @ p["w_r"]).reshape(B, S, H, K), "k": (e["xk"] @ p["w_k"]).reshape(B, S, H, K),
                "v": (e["xv"] @ p["w_v"]).reshape(B, S, H, K), "g": F.silu((e["xg"] @ p["w_g"]).float())}

    def decay(e, lp):
        p = lp["tmix"]
        B, S, _ = e["xk"].shape
        dlora = torch.tanh((e["xk"] @ p["decay_lora_a"]).float()) @ p["decay_lora_b"].float()
        return {"w": torch.exp(-torch.exp(p["decay_base"][None, None] + dlora)).reshape(B, S, H, K)}

    def wkv_step(e, lp):
        y, state = rwkv6._wkv_recurrent(e["r"], e["k"], e["v"], e["w"], lp["tmix"]["bonus_u"], init_state=e["wkv"])
        return {"y": y, "wkv_new": state}

    def group_norm(e, lp):
        y = e["y"]
        B, S = y.shape[:2]
        mean = y.mean(dim=-1, keepdim=True)
        var = torch.square(y - mean).mean(dim=-1, keepdim=True)
        return {"yn": ((y - mean) * torch.rsqrt(var + 1e-5)).reshape(B, S, d) * lp["tmix"]["ln_x_scale"][None, None]}

    def gate(e, lp):
        return {"h1": e["h"] + (e["yn"] * e["g"]).to(e["x"].dtype) @ lp["tmix"]["w_o"]}

    def channel_mix(e, lp):
        cout, _ = rwkv6.apply_channel_mix(lp["cmix"], L.apply_norm(lp["norm2"], e["h1"]), last_x=e["last_cm"])
        return {"h2": e["h1"] + cout}

    return [("norm1", norm1), ("token_shift_and_loras", shift_and_loras), ("projections_r_k_v_g", projections),
            ("decay", decay), ("wkv_step", wkv_step), ("group_norm", group_norm), ("gate_and_w_o", gate),
            ("channel_mix", channel_mix)]


def mamba_block_stages(cfg) -> list:
    """One Mamba2 block's decode step (``Model._mamba_block_step`` with
    ``decode=True``, one token) as named stages, op for op as
    ``models/mamba2.py`` computes it.  Inputs: h [B, 1, d], conv, ssm."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models import mamba2

    di, H, N, P, K_ = mamba2.d_inner(cfg), mamba2.n_ssm_heads(cfg), cfg.ssm_state, cfg.ssm_head_dim, mamba2.CONV_K

    def norm(e, lp):
        return {"xin": L.apply_norm(lp["norm"], e["h"], kind=cfg.norm)}

    def w_in(e, lp):
        return {"proj": e["xin"] @ lp["mixer"]["w_in"]}

    def conv(e, lp):
        window = torch.cat([e["conv"], e["proj"][..., di:2 * di + 2 * N]], dim=1)
        cw = lp["mixer"]["conv_w"].float()
        out = window[:, :1].float() * cw[0]
        for k in range(1, K_):
            out = out + window[:, k:k + 1].float() * cw[k]
        return {"conv_out": F.silu(out).to(e["h"].dtype), "conv_new": window[:, -(K_ - 1):]}

    def ssd_step(e, lp):
        p, c = lp["mixer"], e["conv_out"]
        B = c.shape[0]
        dt = torch.logaddexp(e["proj"][..., 2 * di + 2 * N:].float() + p["dt_bias"], torch.zeros((), device=c.device))
        x = c[..., :di].reshape(B, 1, H, P)
        state, y = mamba2._ssd_step(e["ssm"].float(), x[:, 0].float(), dt[:, 0], -torch.exp(p["a_log"]),
                                    c[:, 0, di:di + N].float(), c[:, 0, di + N:].float())
        return {"y": y[:, None], "ssm_new": state}

    def gate(e, lp):
        B = e["y"].shape[0]
        x = e["conv_out"][..., :di].reshape(B, 1, H, P)
        y = (e["y"] + lp["mixer"]["d_skip"][None, None, :, None] * x.float()).reshape(B, -1, di).to(e["h"].dtype)
        return {"yg": y * F.silu(e["proj"][..., :di].float()).to(e["h"].dtype)}

    def w_out(e, lp):
        return {"h1": e["h"] + e["yg"] @ lp["mixer"]["w_out"]}

    return [("rms_norm", norm), ("w_in", w_in), ("conv", conv), ("ssd_step", ssd_step), ("gate", gate),
            ("w_out", w_out)]


def check_ssm_reference(cfg, params, prompts, dev) -> dict:
    """The card against the CPU on the RWKV6 decoder's first
    DECODE_REF_LAYERS layers (views of the card's weights; their copy on the
    CPU runs the plain versions): one lane, teacher-forced through a prompt
    and a fixed continuation, each token one ``decode_step`` on the kernel
    route (the final LayerNorm on the layernorm kernel).  Every step's
    logits, and the recurrent state after the prompt (token-shift inputs
    and WKV state of both layers), within DECODE_ATOL."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    cfg_r = dataclasses.replace(cfg, n_layers=DECODE_REF_LAYERS)
    cut = dict(params, layers=cut_layers(params["layers"], DECODE_REF_LAYERS))
    seq = [int(t) for t in prompts[0]] + [int(t) for t in prompts[1][:DECODE_NEW]]

    def run(p, d):
        model = build_model(cfg_r)
        cache = model.init_cache(1, DECODE_BUCKET, device=d)
        logits, state = [], None
        with torch.no_grad():
            for t, tok in enumerate(seq):
                lg, cache = model.decode_step(p, cache, torch.tensor([[tok]], device=d), t, use_kernels=True)
                logits.append(lg[0, 0].cpu())
                if t == DECODE_PROMPT - 1:
                    state = {k: v.cpu().clone() for k, v in cache.items()}
        return logits, state

    t0 = time.perf_counter()
    card, card_state = run(cut, dev)
    p_cpu = tree_to(cut, torch.device("cpu"))
    host, host_state = run(p_cpu, torch.device("cpu"))
    logit_err = max((a - b).abs().max().item() for a, b in zip(card, host))
    state_err = {k: (card_state[k] - host_state[k]).abs().max().item() for k in host_state}
    # layer 0's error op by op, at the next token after the prompt, from the
    # CPU's state after the prompt
    model = build_model(cfg_r)
    lp_cpu, lp_card = model._layer(p_cpu, 0)[0], model._layer(cut, 0)[0]
    env = {"h": model.embed(p_cpu, torch.tensor([[seq[DECODE_PROMPT]]])),
           **{k: host_state[k][0] for k in ("last_tm", "last_cm", "wkv")}}
    whole = model._rwkv_layer_step(lp_cpu, env["h"], states={k: env[k] for k in ("last_tm", "last_cm", "wkv")},
                                   decode=True)[0]
    split = stage_split(rwkv_layer_stages(cfg), lp_card, lp_cpu, env, dev, whole=whole)
    result = {"phase": "reference", "config": f"{cfg.name} first {DECODE_REF_LAYERS} layers (cut from "
              f"{cfg.n_layers})", "teacher_forced_tokens": len(seq),
              "tolerance": f"atol {DECODE_ATOL} (every step's logits, the state after the prompt)",
              "step_logits_max_abs_err": logit_err, "state_after_prompt_max_abs_err": state_err,
              "state_after_prompt_max_abs": {k: v.abs().max().item() for k, v in host_state.items()},
              "layer0_error_by_op": split, "seconds": time.perf_counter() - t0}
    emit(result)
    if max(logit_err, *state_err.values()) > DECODE_ATOL:
        raise AssertionError(f"ssm reference: card and CPU differ beyond {DECODE_ATOL}")
    return result


def plain_drains(phase, cfg, model, params, prompts, dev, want) -> tuple:
    """Two DecoderServer drains in plain decode (DECODE_LANES lanes, one
    bucket of DECODE_BUCKET, DECODE_NEW new tokens a request, a shared-clock
    arbiter): the requests in order, then in reverse order, so that each
    lands in another lane after other requests.  Each drain's launches,
    counted from zero, must be ``want(fused steps)`` exactly and no other
    kernel's; one decode and one prefill build; every token at full depth;
    every request the same tokens both ways.  Returns (the drains' records
    by order, a factory of fresh servers)."""
    import torch

    from repro_torch.hwmodel.edgebert_accel import albert_layer_stats
    from repro_torch.kernels import ops
    from repro_torch.serving.dvfs import BatchedDVFSArbiter, LatencyAwareDVFSController, no_early_exit_baseline
    from repro_torch.serving.engine import DecoderServer, Request

    n = len(prompts)
    stats = albert_layer_stats(seq_len=DECODE_BUCKET)
    stats.n_layers = cfg.n_layers
    target = no_early_exit_baseline(stats)["latency_s"] * 2.0

    def fresh():
        arb = BatchedDVFSArbiter(LatencyAwareDVFSController(stats, target))
        return DecoderServer(model, params, batch_lanes=DECODE_LANES, max_seq=DECODE_BUCKET, eos_id=-1,
                             buckets=(DECODE_BUCKET,), arbiter=arb, device=dev)

    drains, servers = {}, {}
    for order in ("forward", "reverse"):
        srv = fresh()
        uids = range(n) if order == "forward" else reversed(range(n))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for i in uids:
            srv.submit(Request(uid=i, tokens=prompts[i], max_new_tokens=DECODE_NEW))
        srv.run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = ops.launch_counts()
        tel = srv.telemetry()
        steps = tel["decode_steps"]
        wanted = {k: want(steps).get(k, 0) for k in launches}
        if launches != wanted:
            raise AssertionError(f"{phase} {order}: launches {launches}, want {wanted}")
        if tel["decode_traces_per_bucket"] != {DECODE_BUCKET: 1} or tel["prefill_traces"] != 1:
            raise AssertionError(f"{phase} {order}: builds per bucket: {tel}")
        gen_toks = [srv.done[i].generated for i in range(n)]
        if any(len(g_) != DECODE_NEW or not all(0 <= t < cfg.vocab_size for t in g_) for g_ in gen_toks):
            raise AssertionError(f"{phase} {order}: generated tokens off: {gen_toks}")
        if not all(x == cfg.n_layers for i in range(n) for x in srv.done[i].token_exit_layers):
            raise AssertionError(f"{phase} {order}: a token left before the last layer")
        servers[order] = srv
        drains[order] = {
            "order": order, "drain_ms": wall, "tokens": tel["tokens"], "tokens_per_s": tel["tokens"] / (wall / 1e3),
            "fused_steps": steps, "launches": launches, "target_latency_s": target,
            "modeled_energy_j": tel["energy_j"], "modeled_energy_per_token_j": tel["energy_j"] / tel["tokens"],
            "deadline_misses": tel["deadline_misses"], "op_switches": tel["op_switches"], "generated": gen_toks,
        }
    for i in range(n):
        if servers["forward"].done[i].generated != servers["reverse"].done[i].generated:
            raise AssertionError(f"{phase} request {i}: its tokens depend on the lane's earlier requests")
    return drains, fresh


# rwkv6-7b's first 16 of 32 layers, for the script's time (with the
# sharded phase and the decode phase's sharded drains the phases took 631 s
# of their 600 s aim; ssm_decode took 64.8 s at full depth)
SSM_DEPTH = 16


def run_ssm_decode_path(dev) -> dict:
    """rwkv6-7b at full width, its first SSM_DEPTH of 32 layers (d_model 4096, 64 WKV
    heads of 64, d_ff 14336, vocab 65536), float32 weights drawn on the
    card from seed 0, through the DecoderServer: plain decode (the family
    has no per-token exit) of DECODE_REQUESTS SyntheticLM requests in
    DECODE_LANES lanes with a shared-clock arbiter.  Checks the launches
    (layernorm once per fused step and once per prefill token, no other
    kernel), one decode and one prefill build, and that the same requests
    submitted in reverse order, so that each lands in another lane after
    another request, get the same tokens (a refill zeroes the lane's
    recurrent state); then times, the fused step and one request's prefill
    profiled alone beside the step's HBM bound, and the card against the
    CPU on the first two layers."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models.model import build_model
    from repro_torch.serving import step_math

    phase = "ssm_decode"
    full_depth = get_config("rwkv6_7b").n_layers
    cfg = dataclasses.replace(get_config("rwkv6_7b"), dtype="float32", remat_policy="none", n_layers=SSM_DEPTH)
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    prefill_tokens = DECODE_REQUESTS * (DECODE_PROMPT - 1)
    # the final LayerNorm once per fused step and once per prefill token
    drains, fresh = plain_drains(phase, cfg, model, params, prompts, dev,
                                 lambda steps: {"layernorm": steps + prefill_tokens})
    split = host_split(fresh(), prompts, sync=True, max_new_tokens=DECODE_NEW)
    drains["forward"]["host_split_ms"] = split
    drains["forward"]["ms_per_fused_step"] = split["lanes_step"] / drains["forward"]["fused_steps"]
    # the fused step (DECODE_STEPS plain steps of the 4 lanes) and one
    # request's prefill (15 one-token full-depth steps), each timed and
    # profiled alone
    cache = model.init_cache(DECODE_LANES, DECODE_BUCKET, device=dev)
    cur = torch.as_tensor(np.asarray(prompts[:DECODE_LANES, -1:], np.int64), device=dev)
    pos = torch.full((DECODE_LANES,), DECODE_PROMPT - 1, dtype=torch.int64, device=dev)

    def fused_steps():
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                step_math.decoder_decode(model, params, cache, cur, pos, use_kernels=True)

    def prefill():
        with torch.no_grad():
            step_math.decoder_prefill(model, params, cache, prompts[0], 0, DECODE_PROMPT, use_kernels=True)

    parts = profile_parts((("fused_step", fused_steps, DECODE_STEPS), ("prefill", prefill, 1)))
    # the step's least time: every layer's weights and the LM head read
    # once, the recurrent state read and written
    layers = params["layers"]
    step_bytes = {"time_mix": n_bytes(layers["tmix"]), "channel_mix": n_bytes(layers["cmix"]),
                  "norms": n_bytes(layers["norm1"]) + n_bytes(layers["norm2"]) + n_bytes(params["final_norm"]),
                  "lm_head": n_bytes(params["lm_head"]), "state_read_and_written": 2 * n_bytes(cache)}
    step_bound_ms = sum(step_bytes.values()) / HBM_BYTES_PER_S * 1e3
    ref = check_ssm_reference(cfg, params, prompts, dev)
    result = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers, "depth_cut_from": full_depth,
        "d_model": cfg.d_model, "wkv_heads": cfg.n_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, "params": drawn["params"], "init_s": drawn["init_s"],
        "mem_free_gb_before_draw": drawn["mem_free_gb_before_draw"],
        "mem_free_gb_after_draw": drawn["mem_free_gb_after_draw"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "requests": DECODE_REQUESTS, "prompt_tokens": DECODE_PROMPT, "max_new_tokens": DECODE_NEW,
        "lanes": DECODE_LANES, "bucket": DECODE_BUCKET, "drains": drains,
        "reverse_order_same_tokens": True, "parts": parts,
        "fused_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()},
        "fused_step_hbm_bound_ms": step_bound_ms, "launches": drains["forward"]["launches"],
        "reference": {k: ref[k] for k in ("step_logits_max_abs_err", "state_after_prompt_max_abs_err",
                                           "layer0_error_by_op")},
    }
    emit(result)
    del params, cache, layers
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8e: the hybrid decoder (zamba2-1.2b: Mamba2 blocks and the shared
# attention block)
# ---------------------------------------------------------------------------

# the first 6 blocks, which hold one call of the shared block
HYBRID_REF_LAYERS = 6


def rel_err(a, b) -> float:
    """max |a - b| over the largest magnitude of b (at least 1)."""
    return (a - b).abs().max().item() / max(1.0, b.abs().max().item())


def check_hybrid_reference(cfg, params, prompts, dev) -> dict:
    """The card against the CPU on the hybrid decoder's first
    HYBRID_REF_LAYERS blocks (one shared-block call; views of the card's
    weights, their copy on the CPU): one lane, teacher-forced through a
    prompt and a fixed continuation, each token one ``decode_step``.  Every
    step's logits within DECODE_ATOL, and the state after the prompt (conv,
    SSM state, the shared block's K/V) within DECODE_ATOL of each leaf's
    largest magnitude; then block 0's error op by op."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    L_ = HYBRID_REF_LAYERS
    cfg_r = dataclasses.replace(cfg, n_layers=L_)
    cut = dict(params, layers=cut_layers(params["layers"], L_))
    seq = [int(t) for t in prompts[0]] + [int(t) for t in prompts[1][:DECODE_NEW]]

    def run(p, d):
        model = build_model(cfg_r)
        cache = model.init_cache(1, DECODE_BUCKET, device=d)
        logits, state = [], None
        with torch.no_grad():
            for t, tok in enumerate(seq):
                lg, cache = model.decode_step(p, cache, torch.tensor([[tok]], device=d), t, use_kernels=True)
                logits.append(lg[0, 0].cpu())
                if t == DECODE_PROMPT - 1:
                    state = {k: v.cpu().clone() for k, v in cache.items()}
        return logits, state

    t0 = time.perf_counter()
    card, card_state = run(cut, dev)
    p_cpu = tree_to(cut, torch.device("cpu"))
    host, host_state = run(p_cpu, torch.device("cpu"))
    logit_err = max((a - b).abs().max().item() for a, b in zip(card, host))
    state_rel = {k: rel_err(card_state[k], host_state[k]) for k in host_state}
    model = build_model(cfg_r)
    lp_cpu, lp_card = model._layer(p_cpu, 0)[0], model._layer(cut, 0)[0]
    env = {"h": model.embed(p_cpu, torch.tensor([[seq[DECODE_PROMPT]]])),
           "conv": host_state["conv"][0], "ssm": host_state["ssm"][0]}
    whole = model._mamba_block_step(lp_cpu, env["h"], states={"conv": env["conv"], "ssm": env["ssm"]},
                                    decode=True)[0]
    split = stage_split(mamba_block_stages(cfg), lp_card, lp_cpu, env, dev, whole=whole)
    result = {"phase": "reference", "config": f"{cfg.name} first {L_} blocks and 1 shared-block call (cut from "
              f"{cfg.n_layers})", "teacher_forced_tokens": len(seq),
              "tolerance": f"atol {DECODE_ATOL} (every step's logits); the state after the prompt within "
                           f"{DECODE_ATOL} of each leaf's largest magnitude",
              "step_logits_max_abs_err": logit_err, "state_after_prompt_rel_err": state_rel,
              "state_after_prompt_max_abs": {k: v.abs().max().item() for k, v in host_state.items()},
              "block0_error_by_op": split, "seconds": time.perf_counter() - t0}
    emit(result)
    if logit_err > DECODE_ATOL or max(state_rel.values()) > DECODE_ATOL:
        raise AssertionError(f"hybrid reference: card and CPU differ beyond {DECODE_ATOL}")
    return result


def run_hybrid_decode_path(dev) -> dict:
    """zamba2-1.2b at full width and depth (38 Mamba2 blocks of d_model
    2048: d_inner 4096, 64 SSD heads of 64, state 64, chunk 128; the shared
    attention block after every 6th block at width 4096, 32 x 128 heads,
    d_ff 8192; vocab 32000), float32 weights drawn on the card from seed 0,
    through the DecoderServer: plain decode (the family has no per-token
    exit) of DECODE_REQUESTS SyntheticLM requests in DECODE_LANES lanes with
    a shared-clock arbiter.  Checks that no kernel launched (the family's
    norms are RMS, the shared block's cache attention stays on the
    reference ops: ``ops.HYBRID_DECODE_KERNELS`` is empty), one decode and
    one prefill build, the same tokens for every request when the requests
    come in reverse order (a refill zeroes the lane's state), and
    ``Model.prefill`` (the chunked SSD) of every prompt against the
    server's one-token prefill (logits, conv and SSM state within 1e-4 of
    each leaf's largest magnitude); then times, the fused step and one
    request's prefill profiled alone beside the step's HBM bound, and the
    card against the CPU on the first 6 blocks."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import step_math

    phase = "hybrid_decode"
    cfg = dataclasses.replace(get_config("zamba2_1p2b"), dtype="float32", remat_policy="none")
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    n = DECODE_REQUESTS
    if ops.HYBRID_DECODE_KERNELS:
        raise AssertionError(f"{phase}: the path lists kernels {ops.HYBRID_DECODE_KERNELS}, want none")
    drains, fresh = plain_drains(phase, cfg, model, params, prompts, dev, lambda steps: {})

    split = host_split(fresh(), prompts, sync=True, max_new_tokens=DECODE_NEW)
    fwd = drains["forward"]
    fwd["host_split_ms"] = split
    fwd["ms_per_fused_step"] = split["lanes_step"] / fwd["fused_steps"]
    fwd["prefill_share"] = split["lane_load"] / split["wall"]

    # Model.prefill (the chunked SSD over the padded chunk) of all prompts
    # at once, against the server's one-token prefill of each lane and one
    # batched decode step of the prompts' last tokens
    toks = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        lg_chunked, c_chunked = model.prefill(params, toks, model.init_cache(n, DECODE_BUCKET, device=dev))
        torch.cuda.synchronize()
        chunked_ms = (time.perf_counter() - t0) * 1e3
        c_steps = model.init_cache(n, DECODE_BUCKET, device=dev)
        for lane in range(n):
            step_math.decoder_prefill(model, params, c_steps, prompts[lane], lane, DECODE_PROMPT)
        lg_steps, c_steps = model.decode_step(params, c_steps, toks[:, -1:],
                                              torch.full((n,), DECODE_PROMPT - 1, device=dev))
    prefill_cmp = {"logits": rel_err(lg_chunked, lg_steps), **{k: rel_err(c_chunked[k], c_steps[k])
                                                                for k in ("conv", "ssm")},
                   "chunked_prefill_ms": chunked_ms,
                   "tolerance": "1e-4 of each leaf's largest magnitude (logits at least 1)"}
    if max(v for k, v in prefill_cmp.items() if k in ("logits", "conv", "ssm")) > DECODE_ATOL:
        raise AssertionError(f"{phase}: the chunked prefill differs from the one-token prefill: {prefill_cmp}")

    # the fused step (DECODE_STEPS plain steps of the 4 lanes) and one
    # request's prefill (15 one-token full-depth steps), each timed and
    # profiled alone
    cache = model.init_cache(DECODE_LANES, DECODE_BUCKET, device=dev)
    cur = toks[:DECODE_LANES, -1:]
    pos = torch.full((DECODE_LANES,), DECODE_PROMPT - 1, dtype=torch.int64, device=dev)

    def fused_steps():
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                step_math.decoder_decode(model, params, cache, cur, pos, use_kernels=True)

    def prefill():
        with torch.no_grad():
            step_math.decoder_prefill(model, params, cache, prompts[0], 0, DECODE_PROMPT, use_kernels=True)

    parts = profile_parts((("fused_step", fused_steps, DECODE_STEPS), ("prefill", prefill, 1)))
    # the step's least time: every block's weights, the shared block's once
    # per call, the LM head, the recurrent state read and written, the
    # shared block's K/V rows read
    layers, n_attn = params["layers"], cfg.n_layers // cfg.attn_every
    step_bytes = {"mamba_blocks": n_bytes(layers), "shared_block_per_call": n_attn * n_bytes(params["shared_attn"]),
                  "lm_head": n_bytes(params["lm_head"]),
                  "state_read_and_written": 2 * (n_bytes(cache["conv"]) + n_bytes(cache["ssm"])),
                  "kv_cache": n_bytes(cache["k"]) + n_bytes(cache["v"])}
    step_bound_ms = sum(step_bytes.values()) / HBM_BYTES_PER_S * 1e3
    ref = check_hybrid_reference(cfg, params, prompts, dev)
    result = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "ssm_heads": 2 * cfg.d_model // cfg.ssm_head_dim, "ssm_state": cfg.ssm_state,
        "shared_block_calls": n_attn, "n_heads": cfg.n_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": drawn["params"], "init_s": drawn["init_s"],
        "mem_free_gb_before_draw": drawn["mem_free_gb_before_draw"],
        "mem_free_gb_after_draw": drawn["mem_free_gb_after_draw"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "requests": n, "prompt_tokens": DECODE_PROMPT, "max_new_tokens": DECODE_NEW, "lanes": DECODE_LANES,
        "bucket": DECODE_BUCKET, "drains": drains,
        "reverse_order_same_tokens": True, "chunked_vs_one_token_prefill": prefill_cmp, "parts": parts,
        "fused_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()},
        "fused_step_hbm_bound_ms": step_bound_ms, "launches": fwd["launches"],
        "reference": {k: ref[k] for k in ("step_logits_max_abs_err", "state_after_prompt_rel_err",
                                           "block0_error_by_op")},
    }
    emit(result)
    del params, cache, layers, c_chunked, c_steps
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8f: the encoder-decoder (whisper-medium) at model level
# ---------------------------------------------------------------------------

# the card against the CPU on the first 2 encoder and 2 decoder layers
ENCDEC_REF_LAYERS = 2


def encode_flops(cfg, B: int) -> dict:
    """The encoder's operations over B x enc_seq_len frames: the layers'
    projections and MLPs, the attention products, and the decoder's cross
    K/V projections, 2 operations per multiply-add."""
    S, d, H, hd = cfg.enc_seq_len, cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"layers": 2.0 * B * S * (2 * d * H * hd + 2 * d * cfg.n_kv_heads * hd + 2 * d * cfg.d_ff)
            * cfg.n_enc_layers,
            "attention": 4.0 * B * H * S * S * hd * cfg.n_enc_layers,
            "cross_kv": 2.0 * B * S * d * 2 * cfg.n_kv_heads * hd * cfg.n_layers}


def check_encdec_reference(cfg, params, frames, prompts, cont, dev) -> dict:
    """The card against the CPU on the first ENCDEC_REF_LAYERS encoder and
    decoder layers (views of the card's weights, the decoder's position
    table cut to the bucket; their copy on the CPU): the prefill of the
    prompts over the frames, then each continuation token one teacher-
    forced ``decode_step`` on the kernel route; the prefill's logits and
    every step's within DECODE_ATOL."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    L_ = ENCDEC_REF_LAYERS
    cfg_r = dataclasses.replace(cfg, n_layers=L_, n_enc_layers=L_, max_seq_len=DECODE_BUCKET)
    cut = dict(params, layers=cut_layers(params["layers"], L_), enc_layers=cut_layers(params["enc_layers"], L_),
               dec_cross=cut_layers(params["dec_cross"], L_),
               embed=dict(params["embed"], pos=params["embed"]["pos"][:DECODE_BUCKET]))
    B, S = prompts.shape

    def run(p, d):
        model = build_model(cfg_r)
        with torch.no_grad():
            cache = model.init_cache(B, DECODE_BUCKET, device=d)
            lg, cache = model.prefill(p, prompts.to(d), cache, aux={"enc_input": frames.to(d)})
            out = [lg.cpu()]
            for t in range(cont.shape[1]):
                lg, cache = model.decode_step(p, cache, cont[:, t:t + 1].to(d), S + t, use_kernels=True)
                out.append(lg.cpu())
        return out

    t0 = time.perf_counter()
    card = run(cut, dev)
    host = run(tree_to(cut, torch.device("cpu")), torch.device("cpu"))
    errs = [(a - b).abs().max().item() for a, b in zip(card, host)]
    result = {"phase": "reference", "config": f"{cfg.name} first {L_} encoder and {L_} decoder layers (cut from "
              f"{cfg.n_enc_layers} + {cfg.n_layers})", "lanes": B, "frames": cfg.enc_seq_len,
              "teacher_forced_steps": cont.shape[1], "tolerance": f"atol {DECODE_ATOL} (the prefill's and every "
              "step's logits)", "prefill_logits_max_abs_err": errs[0], "step_logits_max_abs_err": max(errs[1:]),
              "logits_max_abs": max(b.abs().max().item() for b in host), "seconds": time.perf_counter() - t0}
    emit(result)
    if max(errs) > DECODE_ATOL:
        raise AssertionError(f"encdec reference: card and CPU differ beyond {DECODE_ATOL}")
    return result


def run_encdec_decode_path(dev) -> dict:
    """whisper-medium at full width and depth (24 encoder and 24 decoder
    layers of d_model 1024, 16 x 64 heads, d_ff 4096, vocab 51865, 1500
    frames; the learned position table at the config's 524288 rows),
    float32 weights drawn on the card from seed 0.  First through the
    model's own entry points: seeded frames [4, 1500, 1024] x 0.1,
    ``init_cache(4, 32)`` -> ``prefill`` of 16-token SyntheticLM prompts
    with ``aux={"enc_input": frames}`` -> DECODE_NEW greedy
    ``decode_step(use_kernels=True)``; layernorm launched once per decode
    step (its final norm) and nothing else, none in the prefill; finite
    logits; frames from another seed changing the logits.  Then served as
    the JAX server serves it (no frames: zero cross K/V, the prefill
    one-token decode_steps): plain DecoderServer drains of DECODE_REQUESTS
    requests with an arbiter, in order and in reverse order (the same
    tokens), layernorm once per fused step and once per prefill token and
    nothing else (``plain_drains``), the host split by hook.  Then times the
    encoder, the prefill and a decode step against their bounds, and the
    card against the CPU on the first 2 + 2 layers."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model

    phase = "encdec_decode"
    cfg = dataclasses.replace(get_config("whisper_medium"), dtype="float32", remat_policy="none")
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    B = DECODE_LANES
    prompts = torch.as_tensor(np.asarray(SyntheticLM(cfg.vocab_size, DECODE_PROMPT, B, seed=0).batch(0)["tokens"],
                                         np.int64), device=dev)
    cont = torch.as_tensor(np.asarray(SyntheticLM(cfg.vocab_size, DECODE_NEW, B, seed=1).batch(0)["tokens"],
                                      np.int64))

    def frames_of(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(B, cfg.enc_seq_len, cfg.d_model, generator=g, device=dev) * 0.1

    frames = frames_of(1)

    def prefill(fr):
        with torch.no_grad():
            return model.prefill(params, prompts, model.init_cache(B, DECODE_BUCKET, device=dev),
                                 aux={"enc_input": fr})

    # the path: prefill, then greedy decode steps, launches counted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg, cache = prefill(frames)
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = ops.launch_counts()
    logits, generated = [lg], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        cur = lg[:, -1].argmax(-1, keepdim=True)
        for t in range(DECODE_NEW):
            generated.append(cur[:, 0].cpu().tolist())
            lg, cache = model.decode_step(params, cache, cur, DECODE_PROMPT + t, use_kernels=True)
            logits.append(lg)
            cur = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    if any(prefill_launches.values()):
        raise AssertionError(f"{phase}: the prefill launched {prefill_launches}, want nothing")
    if launches["layernorm"] != DECODE_NEW or any(v for k, v in launches.items() if k not in ops.ENCDEC_DECODE_KERNELS):
        raise AssertionError(f"{phase}: launches {launches}, want layernorm = {DECODE_NEW} decode steps and "
                             "nothing else")
    if not all(torch.isfinite(x).all() and x.shape == (B, 1, cfg.vocab_size) for x in logits):
        raise AssertionError(f"{phase}: logits not finite or of the wrong shape")
    other, _ = prefill(frames_of(2))
    frames_effect = (other - logits[0]).abs().max().item()
    if frames_effect < 1e-3:
        raise AssertionError(f"{phase}: frames from another seed move the logits by only {frames_effect}")

    # served as the JAX server serves it: no frames reach the server (its
    # cross K/V stay zero), the prefill is one-token decode_steps; layernorm
    # once per fused step and once per prefill token, nothing else
    prefill_tokens = DECODE_REQUESTS * (DECODE_PROMPT - 1)
    served_prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    drains, fresh = plain_drains(phase, cfg, model, params, served_prompts, dev,
                                 lambda steps: {"layernorm": steps + prefill_tokens})
    split = host_split(fresh(), served_prompts, sync=True, max_new_tokens=DECODE_NEW)
    drains["forward"].update(host_split_ms=split, ms_per_fused_step=split["lanes_step"] / drains["forward"]["fused_steps"],
                             prefill_share=split["lane_load"] / split["wall"])

    # the encoder, the prefill and a decode step timed alone, against their
    # bounds: the encoder's and the prefill's operations at the fp32 rate,
    # the step's bytes at the HBM rate
    flops = encode_flops(cfg, B)

    def encode():
        with torch.no_grad():
            model._encode(params, frames)

    step_cache = cache

    def steps():
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                model.decode_step(params, step_cache, cur, DECODE_PROMPT + DECODE_NEW, use_kernels=True)

    parts = profile_parts((("encode", encode, 1), ("prefill", lambda: prefill(frames), 1),
                           ("decode_step", steps, DECODE_STEPS)))
    xattn = params["dec_cross"]["xattn"]
    step_bytes = {"decoder_layers": n_bytes(params["layers"]),
                  "cross_wq_wo_and_norms": n_bytes(xattn["wq"]) + n_bytes(xattn["wo"])
                  + n_bytes(params["dec_cross"]["norm"]),
                  "lm_head": n_bytes(params["lm_head"]), "cross_kv_cache": n_bytes(cache["enc_k"])
                  + n_bytes(cache["enc_v"]), "self_kv_cache": n_bytes(cache["k"]) + n_bytes(cache["v"])}
    bounds = {"encode_ms": (flops["layers"] + flops["attention"]) / FP32_FLOP_PER_S * 1e3,
              "prefill_ms": sum(flops.values()) / FP32_FLOP_PER_S * 1e3,
              "decode_step_ms": sum(step_bytes.values()) / HBM_BYTES_PER_S * 1e3}
    ref = check_encdec_reference(cfg, params, frames, prompts, cont, dev)
    result = {
        "phase": phase, "config": cfg.name, "n_enc_layers": cfg.n_enc_layers, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "frames": cfg.enc_seq_len, "dtype": cfg.dtype, "params": drawn["params"],
        "bytes": drawn["bytes"], "init_s": drawn["init_s"],
        "mem_free_gb_before_draw": drawn["mem_free_gb_before_draw"],
        "mem_free_gb_after_draw": drawn["mem_free_gb_after_draw"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "lanes": B, "prompt_tokens": DECODE_PROMPT, "decode_steps": DECODE_NEW, "bucket": DECODE_BUCKET,
        "first_prefill_ms": first_prefill_ms, "decode_ms": decode_ms,
        "tokens_per_s": B * DECODE_NEW / (decode_ms / 1e3), "generated": generated,
        "prefill_launches": prefill_launches, "model_level_launches": launches,
        "frames_effect_max_abs": frames_effect, "served_drains": drains, "reverse_order_same_tokens": True,
        "launches": drains["forward"]["launches"],
        "tflop": {k: v / 1e12 for k, v in flops.items()}, "parts": parts,
        "decode_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()}, "bounds_ms": bounds,
        "reference": {k: ref[k] for k in ("prefill_logits_max_abs_err", "step_logits_max_abs_err")},
    }
    emit(result)
    del params, cache, step_cache, logits, other
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8g: the vision decoder (llama-3.2-vision-90b), cut in depth
# ---------------------------------------------------------------------------

# llama-3.2-vision-90b at full width, its first 10 of 100 layers: two
# groups of 4 self layers closed by a gated cross layer (the whole model's
# 350.7 GB of float32 weights exceed the card)
VLM_DEPTH = 10
# the card against the CPU on the first group (4 self layers and 1 cross
# layer; a copy of ~25.7 GB on the host) at 2 lanes: the prefill over the
# image and VLM_REF_STEPS teacher-forced decode steps, logits within
# DECODE_ATOL of their largest magnitude
VLM_REF_LANES = 2
VLM_REF_STEPS = 4


def vlm_prefill_flops(cfg, B: int) -> float:
    """A vlm prefill's operations (2 per multiply-add) over B prompts of
    DECODE_PROMPT tokens and their images: every cross layer's image K/V
    projection, the self layers' projections and MLPs and the cross
    layers' q / o projections and MLPs per token, the attention products
    (causal over the prompt, every token against every image token), the
    LM head on the last token."""
    d, H, KV, hd, ff, S, n_img = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, DECODE_PROMPT,
                                  cfg.n_image_tokens)
    n_cross = cfg.n_layers // cfg.cross_attn_every
    n_self = cfg.n_layers - n_cross
    per_token_self = 2 * d * (2 * H * hd + 2 * KV * hd) + 2 * 3 * d * ff
    per_token_cross = 2 * d * 2 * H * hd + 2 * 3 * d * ff
    return (2.0 * B * n_img * d * 2 * KV * hd * n_cross
            + B * S * (n_self * per_token_self + n_cross * per_token_cross)
            + 4.0 * B * H * hd * (n_self * S * S / 2 + n_cross * S * n_img)
            + 2.0 * B * d * cfg.vocab_size)


def check_vlm_reference(cfg, params, image, prompts, cont, dev) -> dict:
    """The card against the CPU on the vlm's first group (views of the
    card's weights: 4 self layers and cross layer 0; their copy on the
    CPU): the prefill of VLM_REF_LANES prompts over their images, then
    VLM_REF_STEPS teacher-forced ``decode_step``s; the prefill's logits and
    every step's within DECODE_ATOL of the largest logit magnitude (at
    least 1)."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    every = cfg.cross_attn_every
    cfg_r = dataclasses.replace(cfg, n_layers=every)
    cut = dict(params, layers=cut_layers(params["layers"], every - 1),
               cross_layers=cut_layers(params["cross_layers"], 1))
    B = VLM_REF_LANES
    img, toks, cont = image[:B], prompts[:B], cont[:B]

    def run(p, d):
        model = build_model(cfg_r)
        with torch.no_grad():
            cache = model.init_cache(B, DECODE_BUCKET, device=d)
            lg, cache = model.prefill(p, toks.to(d), cache, aux={"image_embeds": img.to(d)})
            out = [lg.cpu()]
            for t in range(VLM_REF_STEPS):
                lg, cache = model.decode_step(p, cache, cont[:, t:t + 1].to(d), toks.shape[1] + t, use_kernels=True)
                out.append(lg.cpu())
        return out

    t0 = time.perf_counter()
    card = run(cut, dev)
    host = run(tree_to(cut, torch.device("cpu")), torch.device("cpu"))
    errs = [rel_err(a, b) for a, b in zip(card, host)]
    result = {"phase": "reference", "config": f"{cfg.name} first group: {every - 1} self layers and 1 cross layer "
              f"(cut from {cfg.n_layers})", "lanes": B, "image_tokens": cfg.n_image_tokens,
              "teacher_forced_steps": VLM_REF_STEPS,
              "tolerance": f"{DECODE_ATOL} of the largest logit magnitude (the prefill's and every step's)",
              "prefill_logits_rel_err": errs[0], "step_logits_rel_err": max(errs[1:]),
              "logits_max_abs": max(b.abs().max().item() for b in host), "seconds": time.perf_counter() - t0}
    emit(result)
    if max(errs) > DECODE_ATOL:
        raise AssertionError(f"vlm reference: card and CPU differ beyond {DECODE_ATOL} of the logits' magnitude")
    return result


def run_vlm_decode_path(dev) -> dict:
    """llama-3.2-vision-90b at full width (d_model 8192, 64 x 128 query
    heads over 8 KV heads, d_ff 28672, vocab 128256, 1601 image tokens),
    its first VLM_DEPTH of 100 layers (2 groups of 4 self layers and 1
    gated cross layer), float32 weights drawn on the card from seed 0 and
    the cross layers' gates then drawn nonzero (their init of zero makes
    each cross layer the identity).  At model level: seeded image
    embeddings [4, 1601, 8192] x 0.1, ``init_cache(4, 32)`` -> ``prefill``
    of 16-token SyntheticLM prompts with ``aux={"image_embeds": ...}`` ->
    DECODE_NEW greedy ``decode_step``s; no kernel launched
    (``ops.VLM_DECODE_KERNELS`` is empty: RMS norms, cache and cross
    attention on the reference ops); finite logits; an image from another
    seed moving them.  Then served as the JAX server serves it (no image:
    zero image K/V): plain DecoderServer drains with an arbiter, in order
    and in reverse order (the same tokens), no kernel launched
    (``plain_drains``), the host split by hook.  Then the fused step, one
    request's serving prefill and the model's prefill timed and profiled
    alone beside their bounds, and the card against the CPU on the first
    group."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.serving import step_math

    phase = "vlm_decode"
    cfg = dataclasses.replace(get_config("llama3_2_vision_90b"), dtype="float32", remat_policy="none",
                              n_layers=VLM_DEPTH)
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name in ("gate_attn", "gate_mlp"):
        params["cross_layers"][name].uniform_(0.3, 1.0, generator=gen)
    gates = {name: params["cross_layers"][name].tolist() for name in ("gate_attn", "gate_mlp")}
    emit({"phase": f"{phase}_gates", **gates})
    if ops.VLM_DECODE_KERNELS:
        raise AssertionError(f"{phase}: the path lists kernels {ops.VLM_DECODE_KERNELS}, want none")
    B = DECODE_LANES
    prompts = torch.as_tensor(np.asarray(SyntheticLM(cfg.vocab_size, DECODE_PROMPT, B, seed=0).batch(0)["tokens"],
                                         np.int64), device=dev)
    cont = torch.as_tensor(np.asarray(SyntheticLM(cfg.vocab_size, DECODE_NEW, B, seed=1).batch(0)["tokens"],
                                      np.int64))

    def image_of(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(B, cfg.n_image_tokens, cfg.d_model, generator=g, device=dev) * 0.1

    image = image_of(1)

    def prefill(img):
        with torch.no_grad():
            return model.prefill(params, prompts, model.init_cache(B, DECODE_BUCKET, device=dev),
                                 aux={"image_embeds": img})

    # the model level: prefill over the image, then greedy decode steps
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lg, cache = prefill(image)
    torch.cuda.synchronize()
    first_prefill_ms = (time.perf_counter() - t0) * 1e3
    logits, generated = [lg], []
    t0 = time.perf_counter()
    with torch.no_grad():
        cur = lg[:, -1].argmax(-1, keepdim=True)
        for t in range(DECODE_NEW):
            generated.append(cur[:, 0].cpu().tolist())
            lg, cache = model.decode_step(params, cache, cur, DECODE_PROMPT + t, use_kernels=True)
            logits.append(lg)
            cur = lg[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    model_launches = ops.launch_counts()
    if any(model_launches.values()):
        raise AssertionError(f"{phase}: the model level launched {model_launches}, want nothing")
    if not all(torch.isfinite(x).all() and x.shape == (B, 1, cfg.vocab_size) for x in logits):
        raise AssertionError(f"{phase}: logits not finite or of the wrong shape")
    other, _ = prefill(image_of(2))
    image_effect = (other - logits[0]).abs().max().item()
    if image_effect < 1e-3:
        raise AssertionError(f"{phase}: an image from another seed moves the logits by only {image_effect}")
    del other

    # served as the JAX server serves it: no image reaches the server
    served_prompts = SyntheticLM(cfg.vocab_size, DECODE_PROMPT, DECODE_REQUESTS, seed=0).batch(0)["tokens"]
    drains, fresh = plain_drains(phase, cfg, model, params, served_prompts, dev, lambda steps: {})
    split = host_split(fresh(), served_prompts, sync=True, max_new_tokens=DECODE_NEW)
    fwd = drains["forward"]
    fwd.update(host_split_ms=split, ms_per_fused_step=split["lanes_step"] / fwd["fused_steps"],
               prefill_share=split["lane_load"] / split["wall"])

    # the fused step (DECODE_STEPS plain 4-lane steps), one request's
    # serving prefill (15 one-token steps) and the model's prefill over the
    # image, each timed and profiled alone
    step_cache = model.init_cache(B, DECODE_BUCKET, device=dev)
    pos = torch.full((B,), DECODE_PROMPT - 1, dtype=torch.int64, device=dev)

    def fused_steps():
        with torch.no_grad():
            for _ in range(DECODE_STEPS):
                step_math.decoder_decode(model, params, step_cache, prompts[:, -1:], pos, use_kernels=True)

    def serving_prefill():
        with torch.no_grad():
            step_math.decoder_prefill(model, params, step_cache, served_prompts[0], 0, DECODE_PROMPT,
                                      use_kernels=True)

    parts = profile_parts((("fused_step", fused_steps, DECODE_STEPS), ("serving_prefill", serving_prefill, 1),
                           ("model_prefill", lambda: prefill(image), 1)))
    # a 4-lane step's least time: every layer's weights, the cross layers',
    # the LM head and the final norm read once, the self K/V and the image
    # K/V rows read (4 rows of the embedding table: nothing)
    step_bytes = {"self_layers": n_bytes(params["layers"]), "cross_layers": n_bytes(params["cross_layers"]),
                  "lm_head_and_final_norm": n_bytes(params["lm_head"]) + n_bytes(params["final_norm"]),
                  "self_kv_cache": n_bytes(step_cache["k"]) + n_bytes(step_cache["v"]),
                  "image_kv_cache": n_bytes(step_cache["img_k"]) + n_bytes(step_cache["img_v"])}
    bounds = {"fused_step_ms": sum(step_bytes.values()) / HBM_BYTES_PER_S * 1e3,
              "model_prefill_ms": bound_ms(n_bytes(params) - n_bytes(params["embed"]),
                                           vlm_prefill_flops(cfg, B))[0]}
    ref = check_vlm_reference(cfg, params, image, prompts, cont, dev)
    result = {
        "phase": phase, "config": f"{cfg.name} first {VLM_DEPTH} of 100 layers", "n_layers": cfg.n_layers,
        "cross_attn_every": cfg.cross_attn_every, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
        "image_tokens": cfg.n_image_tokens, "dtype": cfg.dtype, "params": drawn["params"], "bytes": drawn["bytes"],
        "init_s": drawn["init_s"], "gates": gates, "mem_free_gb_before_draw": drawn["mem_free_gb_before_draw"],
        "mem_free_gb_after_draw": drawn["mem_free_gb_after_draw"],
        "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
        "lanes": B, "prompt_tokens": DECODE_PROMPT, "decode_steps": DECODE_NEW, "bucket": DECODE_BUCKET,
        "first_prefill_ms": first_prefill_ms, "decode_ms": decode_ms, "generated": generated,
        "model_level_launches": model_launches, "image_effect_max_abs": image_effect,
        "served_drains": drains, "reverse_order_same_tokens": True, "parts": parts,
        "fused_step_bytes_gb": {k: v / 1e9 for k, v in step_bytes.items()}, "bounds_ms": bounds,
        "model_prefill_tflop": vlm_prefill_flops(cfg, B) / 1e12, "launches": fwd["launches"],
        "reference": {k: ref[k] for k in ("prefill_logits_rel_err", "step_logits_rel_err", "logits_max_abs")},
    }
    emit(result)
    del params, cache, step_cache, logits, image
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 8h: a decoder trained on the card (zamba2-1.2b)
# ---------------------------------------------------------------------------

# zamba2-1.2b at full width and depth in float32, SyntheticLM batches of
# 4 x 128 tokens: one ssm_chunk of the SSD, where the JAX package's order
# of exp and mask gives NaN gradients; AdamW steps through make_train_step
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 128
LM_TRAIN_STEPS = 3
# the card against the CPU on the first 6 blocks (one shared-block call):
# the loss within 1e-4 relative, every gradient leaf within 1e-4 of its
# largest magnitude
LM_TRAIN_REF_LAYERS = 6
LM_TRAIN_RTOL = 1e-4
# the same step under each remat_policy: the three policies' gradients of
# one batch within 1e-6 of each leaf's largest magnitude (a region's second
# run repeats its first), each step's wall, busy and peak memory
LM_TRAIN_POLICY_RTOL = 1e-6
# one AdamW step under "full" at train_4k's sequence (4 x 4096), a step
# that "none" cannot hold on the card; the dry run models 49.8 GB of temp
# for it under "full", and the phase fails above 60 GB
LM_TRAIN_LONG_SEQ = 4096
LM_TRAIN_LONG_TEMP_GB = 60.0
# the phase's dry-run cells ((policy, seq) at LM_TRAIN_BATCH), each traced
# in a spawned process started beside the kernel build and joined before
# the first timed phase, so that no timed part shares the host with them
LM_TRAIN_DRY_CELLS = (("none", LM_TRAIN_SEQ), ("full", LM_TRAIN_LONG_SEQ), ("none", LM_TRAIN_LONG_SEQ))
LM_TRAIN_DRY_TIMEOUT_S = 300


def grads_of(model, params, batch) -> tuple:
    """(loss, gradients) of ``make_loss_fn``'s lm_loss + aux."""
    from repro_torch.training.train_loop import make_loss_fn, value_and_grad

    loss_fn = make_loss_fn(model)
    (loss, _), grads = value_and_grad(lambda p: loss_fn(p, batch), params)
    return loss, grads


def check_lm_train_reference(cfg, params, batch, dev) -> dict:
    """The card against the CPU on the hybrid decoder's first
    LM_TRAIN_REF_LAYERS blocks (views of the card's weights; their copy on
    the CPU): the training loss and every gradient leaf of one batch."""
    import dataclasses

    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.models.model import build_model

    cfg_r = dataclasses.replace(cfg, n_layers=LM_TRAIN_REF_LAYERS)
    cut = dict(params, layers=cut_layers(params["layers"], LM_TRAIN_REF_LAYERS))
    model = build_model(cfg_r)
    t0 = time.perf_counter()
    loss_card, g_card = grads_of(model, cut, batch)
    cpu = torch.device("cpu")
    loss_cpu, g_cpu = grads_of(model, tree_to(cut, cpu), tree_to(batch, cpu))
    leaves_card, leaves_cpu = leaves(g_card), leaves(g_cpu)
    grad_rel = max((a.cpu() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                   for a, b in zip(leaves_card, leaves_cpu))
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    result = {"phase": "reference", "config": f"{cfg.name} first {LM_TRAIN_REF_LAYERS} blocks and 1 shared-block "
              f"call (cut from {cfg.n_layers})", "batch": list(batch["tokens"].shape),
              "tolerance": f"loss {LM_TRAIN_RTOL} relative; every gradient leaf {LM_TRAIN_RTOL} of its largest "
                           "magnitude", "loss_card": float(loss_card), "loss_cpu": float(loss_cpu),
              "loss_rel_err": loss_rel, "grad_rel_err": grad_rel, "grad_leaves": len(leaves_cpu),
              "finite": all(bool(torch.isfinite(x).all()) for x in leaves_card + leaves_cpu),
              "seconds": time.perf_counter() - t0}
    emit(result)
    if not result["finite"] or loss_rel > LM_TRAIN_RTOL or grad_rel > LM_TRAIN_RTOL:
        raise AssertionError(f"lm_train reference: card and CPU differ: {result}")
    return result


def _lm_train_dry_cell(policy: str, seq: int, out: str) -> None:
    """One dry-run cell of the lm_train phase, in a spawned process: the
    phase's config under ``policy``, one AdamW step of LM_TRAIN_BATCH x
    ``seq`` tokens at world 1 traced on fake tensors (nothing runs on the
    card), its record, trace seconds and launch counts written to ``out``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh

    cfg = dataclasses.replace(get_config("zamba2_1p2b"), dtype="float32", remat_policy=policy)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rec = dryrun.record_cell(cfg, ShapeConfig("lm_train", seq, LM_TRAIN_BATCH, "train"),
                             Mesh(("data", "model"), (1, 1)), microbatches=1)
    rec.update(seconds=time.perf_counter() - t0, launches=ops.launch_counts())
    Path(out).write_text(json.dumps(rec))


def spawn_dry_cells(cells) -> dict:
    """Start one spawned process per (policy, seq) cell; {cell: (process,
    its record's path)}.  ``join_dry_cells`` collects them."""
    import multiprocessing

    work = ROOT / "build" / "lm_train_dryrun"
    work.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    handles = {}
    for policy, seq in cells:
        out = work / f"{policy}_{seq}.json"
        out.unlink(missing_ok=True)
        proc = ctx.Process(target=_lm_train_dry_cell, args=(policy, seq, str(out)))
        proc.start()
        handles[(policy, seq)] = (proc, out)
    return handles


def join_dry_cells(handles) -> dict:
    """The records of the cells started by ``spawn_dry_cells``, every
    process joined within LM_TRAIN_DRY_TIMEOUT_S; one that fails, or
    launches a kernel, raises."""
    deadline = time.monotonic() + LM_TRAIN_DRY_TIMEOUT_S
    recs = {}
    for cell, (proc, out) in handles.items():
        proc.join(timeout=max(deadline - time.monotonic(), 1.0))
        if proc.is_alive() or proc.exitcode != 0 or not out.exists():
            raise AssertionError(f"lm_train dryrun {cell}: the trace failed (exit code {proc.exitcode})")
        recs[cell] = json.loads(out.read_text())
        if any(recs[cell]["launches"].values()):
            raise AssertionError(f"lm_train dryrun {cell}: the fake-tensor trace launched "
                                 f"{recs[cell]['launches']}, want nothing")
    return recs


def stop_dry_cells(handles) -> None:
    for proc, _ in handles.values():
        if proc.is_alive():
            proc.kill()
        proc.join(timeout=30)


def lm_train_dryrun(rec: dict, busy_ms: float) -> dict:
    """The dry run (``launch/dryrun.py``) of lm_train's own step: the same
    config, LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens, one AdamW step at world 1,
    traced on fake tensors (nothing runs on the card; ``ops.DRYRUN_KERNELS``
    is empty and the trace fails on any launch).  Its per-device FLOPs and
    bytes, its ``H100_SXM`` roofline bound (a model: the compute term at the
    bf16 dense peak, while this step runs float32) beside the step's
    measured busy ms and their ratio; nothing is asserted on the ratio."""
    rl, oa = rec["roofline"], rec["op_analysis"]
    bound = rl["bound_s"] * 1e3
    out = {"chip": rl["chip"], "flops_per_device": oa["flops_per_device"], "bytes_per_device": oa["bytes_per_device"],
           "t_compute_ms": rl["t_compute_s"] * 1e3, "t_memory_ms": rl["t_memory_s"] * 1e3,
           "bound_ms": bound, "dominant": rl["dominant"], "measured_busy_ms": busy_ms,
           "busy_over_bound": busy_ms / bound if bound else None, "n_params": rec["n_params"],
           "temp_peak_gb": rec["memory_analysis"]["temp_size_in_bytes"] / 1e9, "trace_s": rec["trace_s"],
           "seconds": rec["seconds"], "launches": rec["launches"]}
    print(f"lm_train dryrun ({rl['chip']} roofline, a model): {oa['flops_per_device']:.4e} FLOP, "
          f"{oa['bytes_per_device']:.4e} B per device, bound {bound:.3f} ms ({rl['dominant']}); measured busy "
          f"{busy_ms:.3f} ms, busy / bound {out['busy_over_bound']:.3f}; traced in {rec['seconds']:.1f} s "
          "(a spawned process)", flush=True)
    return out


def run_lm_train_policies(cfg, params, opt_state, batch, opt_cfg) -> dict:
    """The phase's step under each remat_policy on the same params, state
    and batch (warm: each policy's forward and backward ran for its
    gradients, AdamW in the phase's steps), as ``profile_parts`` gives a
    part: one step timed alone (wall ms, and the card's peak memory from
    ``reset_peak_memory_stats``), one profiled (busy ms from the CUDA
    activity alone, idle share, device time by kernel)."""
    import dataclasses

    import torch

    from repro_torch.models.model import REMAT_POLICIES, build_model
    from repro_torch.training.train_loop import make_train_step

    out = {}
    for policy in REMAT_POLICIES:
        step_fn = make_train_step(build_model(dataclasses.replace(cfg, remat_policy=policy)), opt_cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() / 1e9
        by_kernel = profile_device(lambda: step_fn(params, opt_state, batch))
        busy = sum(g_["ms"] for g_ in by_kernel.values())
        if not busy > 0:
            raise AssertionError(f"lm_train {policy}: the profile shows no device time")
        out[policy] = {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / wall,
                       "device_ms_by_kernel": by_kernel, "per": 1, "peak_device_gb": peak}
    return out


def policy_grad_agreement(cfg, params, batch, want) -> dict:
    """The gradients of one batch under "dots" and "full" against ``want``
    (those under "none"): the largest difference over each leaf's largest
    magnitude, per policy; above LM_TRAIN_POLICY_RTOL raises."""
    import dataclasses

    from repro_torch.models.model import build_model

    out = {}
    for policy in ("dots", "full"):
        loss, grads = grads_of(build_model(dataclasses.replace(cfg, remat_policy=policy)), params, batch)
        rel = max(rel_to_magnitude(g, w) for g, w in zip(leaves(grads), leaves(want)))
        out[policy] = {"loss": float(loss), "grad_rel_err_vs_none": rel}
        del grads
        if not rel <= LM_TRAIN_POLICY_RTOL:
            raise AssertionError(f"lm_train: {policy} gradients off those under none by {rel} of a leaf's "
                                 f"magnitude (limit {LM_TRAIN_POLICY_RTOL})")
    return out


def run_lm_train_long(cfg, params, opt_state, opt_cfg, dev, dry: dict) -> dict:
    """One AdamW step under remat "full" at LM_TRAIN_BATCH x
    LM_TRAIN_LONG_SEQ (a SyntheticLM batch from seed 1): its wall ms, finite
    loss, no launch, and the card's peak memory beside the dry run's model
    of the same step (``dry``: its records under "full" and "none" at that
    sequence, the temp under "full" at most LM_TRAIN_LONG_TEMP_GB)."""
    import dataclasses
    import gc

    import torch

    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training.train_loop import make_train_step, to_batch

    seq = LM_TRAIN_LONG_SEQ
    mem = {p: dry[(p, seq)]["memory_analysis"] for p in ("full", "none")}
    if not mem["full"]["temp_size_in_bytes"] / 1e9 <= LM_TRAIN_LONG_TEMP_GB:
        raise AssertionError(f"lm_train long step: the dry run models {mem['full']['temp_size_in_bytes'] / 1e9} GB "
                             f"of temp under full at {seq}, limit {LM_TRAIN_LONG_TEMP_GB}")
    step_fn = make_train_step(build_model(dataclasses.replace(cfg, remat_policy="full")), opt_cfg)
    batch = to_batch(SyntheticLM(cfg.vocab_size, seq, LM_TRAIN_BATCH, seed=1).batch(0), dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    new_params, new_opt, metrics = step_fn(params, opt_state, batch)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = ops.launch_counts()
    del new_params, new_opt, metrics, batch
    out = {"seq": seq, "batch": LM_TRAIN_BATCH, "policy": "full", "loss": loss, "wall_ms": wall,
           "peak_device_gb": peak, "launches": launches,
           "dryrun_peak_gb": mem["full"]["peak_tracked_bytes"] / 1e9,
           "dryrun_temp_gb": mem["full"]["temp_size_in_bytes"] / 1e9,
           "dryrun_argument_gb": mem["full"]["argument_size_in_bytes"] / 1e9,
           "dryrun_none_temp_gb": mem["none"]["temp_size_in_bytes"] / 1e9,
           "dryrun_none_peak_gb": mem["none"]["peak_tracked_bytes"] / 1e9,
           "card_over_dryrun_peak": peak / (mem["full"]["peak_tracked_bytes"] / 1e9),
           "dryrun_bound_ms": dry[("full", seq)]["roofline"]["bound_s"] * 1e3}
    emit(dict(out, phase="lm_train_long"))
    if not math.isfinite(loss):
        raise AssertionError(f"lm_train long step: loss {loss}")
    if any(launches.values()):
        raise AssertionError(f"lm_train long step launched {launches}, want nothing")
    return out


def run_lm_train_path(dev, dry_recs: dict) -> dict:
    """zamba2-1.2b trained on the card at full width and depth (38 Mamba2
    blocks and 6 shared-block calls, float32 weights drawn on the card from
    seed 0): the gradients of one SyntheticLM batch of LM_TRAIN_BATCH x
    LM_TRAIN_SEQ tokens through ``make_loss_fn`` (every leaf finite: the
    chunked SSD masks the decay's exponent before its exp), the same
    gradients under remat "dots" and "full" against them, then
    LM_TRAIN_STEPS AdamW steps through ``make_train_step`` (finite losses
    and gradient norms), no kernel launched (training takes the reference
    ops); one step timed and profiled alone beside its fp32 bound (6 N T
    operations at 67 TFLOP/s) and beside the dry run's H100 roofline bound
    of the same step (``lm_train_dryrun``), and under each remat policy
    with its peak memory; the card against the CPU on the first 6 blocks;
    then one step under "full" at train_4k's sequence
    (``run_lm_train_long``) beside the dry run's memory for it under
    "full" and "none".  ``dry_recs`` holds the records of the dry-run
    cells (LM_TRAIN_DRY_CELLS), traced before the first timed phase."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model
    from repro_torch.training.optim import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import make_train_step, to_batch

    phase = "lm_train"
    if ops.DRYRUN_KERNELS:
        raise AssertionError(f"lm_train dryrun: the path lists kernels {ops.DRYRUN_KERNELS}, want none")
    cfg = dataclasses.replace(get_config("zamba2_1p2b"), dtype="float32", remat_policy="none")
    model = build_model(cfg)
    params, drawn = draw_decoder(cfg, phase, dev)
    data = SyntheticLM(cfg.vocab_size, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=0)
    batch = to_batch(data.batch(0), dev)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    loss0, grads = grads_of(model, params, batch)
    torch.cuda.synchronize()
    grads_ms = (time.perf_counter() - t0) * 1e3
    nonfinite = [i for i, g_ in enumerate(leaves(grads)) if not torch.isfinite(g_).all()]
    grad_max = max(g_.abs().max().item() for g_ in leaves(grads))
    if nonfinite or not torch.isfinite(loss0):
        raise AssertionError(f"{phase}: loss {float(loss0)}, non-finite gradient leaves {nonfinite}")
    agreement = policy_grad_agreement(cfg, params, batch, grads)
    del grads

    opt_cfg = AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=100)
    step_fn = make_train_step(model, opt_cfg)
    opt_state = adamw_init(params)
    history = []
    for step in range(LM_TRAIN_STEPS):
        b = to_batch(data.batch(step), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        history.append({"loss": loss, "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
                        "wall_ms": (time.perf_counter() - t0) * 1e3})
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in history):
        raise AssertionError(f"{phase}: non-finite losses or gradient norms: {history}")

    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    policies = run_lm_train_policies(cfg, params, opt_state, batch, opt_cfg)
    parts = {"train_step": dict(policies["none"])}      # the phase's step, under "none"
    for policy, rec in policies.items():
        rec.pop("device_ms_by_kernel")
        rec.update(agreement.get(policy, {}))
    launches = ops.launch_counts()
    if any(launches.values()):
        raise AssertionError(f"{phase}: training launched {launches}, want nothing")
    dry = lm_train_dryrun(dry_recs[("none", LM_TRAIN_SEQ)], parts["train_step"]["device_busy_ms"])
    n_params = drawn["params"]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = 6.0 * n_params * tokens
    ref = check_lm_train_reference(cfg, params, batch, dev)
    del batch
    long = run_lm_train_long(cfg, params, opt_state, opt_cfg, dev, dry_recs)
    result = {
        "phase": phase, "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "ssm_chunk": cfg.ssm_chunk, "dtype": cfg.dtype, "params": n_params, "bytes": drawn["bytes"],
        "init_s": drawn["init_s"], "mem_free_gb_before_draw": drawn["mem_free_gb_before_draw"],
        "peak_device_gb": peak_gb, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
        "first_loss": float(loss0), "first_grads_ms": grads_ms, "first_grad_max_abs": grad_max,
        "history": history, "launches": launches, "parts": parts, "step_tflop": flops / 1e12,
        "step_fp32_bound_ms": flops / FP32_FLOP_PER_S * 1e3,
        "reference": {k: ref[k] for k in ("loss_rel_err", "grad_rel_err")}, "dryrun": dry,
        "remat_policies": policies, "policy_grad_rtol": LM_TRAIN_POLICY_RTOL, "long_step": long,
    }
    emit(result)
    del params, opt_state
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


# ---------------------------------------------------------------------------
# phase 10: the training half of sharding across ranks (dist_train)
# ---------------------------------------------------------------------------

# qwen3-moe-235b's MoE layer at its published width (d_model 4096, 128
# experts of moe_d_ff 1536, top-8; float32, 9.66 GB of expert weights split
# over the model ranks), forward and backward on DIST_TRAIN_TOKENS tokens at
# the model's capacity factor; pipeline stages of d_model x d_model
# linear + tanh, DIST_PIPE_MICRO microbatches of DIST_PIPE_MB rows
DIST_TRAIN_ARCH = "qwen3_moe_235b"
DIST_TRAIN_TOKENS = (4, 128)
DIST_TRAIN_CF = 1.25
DIST_TRAIN_RTOL = 1e-5
DIST_TRAIN_ITERS = 3
DIST_PIPE_MICRO = 8
DIST_PIPE_MB = 4
DIST_TIMEOUT_S = 420


def rel_to_magnitude(a, b) -> float:
    """max |a - b| over the largest magnitude of b (``rel_err`` floors the
    magnitude at 1; a gradient leaf's is far below it)."""
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _dist_rank(rank: int, world: int, backend: str, cards: list, store: str, out: str) -> None:
    """One rank of the dist_train phase, in a spawned process on card
    ``cards[rank]``: joins the group over a file store, runs
    ``dist_train_rank`` and writes its record to ``out/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device

    torch.cuda.set_device(cards[rank])
    dev = resolve_device(f"cuda:{cards[rank]}")
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        rec = dist_train_rank(rank, world, backend, dev)
        Path(out, f"rank{rank}.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def dist_train_rank(rank: int, world: int, backend: str, dev) -> dict:
    """The expert-parallel MoE layer on a (data 1, model world) mesh, its
    gradients through compressed_psum over the world group beside a plain
    fp32 all_reduce of the same tree, the pipeline (NCCL only: gloo has no
    send / recv of CUDA tensors); each held against the same computation
    unsharded on this rank's card, with no kernel launched."""
    import gc
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import Mesh, device_mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.training.compress import compressed_psum, ef_init

    cfg = replace(get_config(DIST_TRAIN_ARCH), dtype="float32", moe_shardmap_dispatch=True)
    mesh = device_mesh(Mesh(("data", "model"), (1, world)), "cuda")
    e_loc = cfg.n_experts // world
    B, S = DIST_TRAIN_TOKENS

    def draw_full():
        return moe.init_moe(cfg, torch.Generator(device=dev).manual_seed(0), dev, torch.float32)

    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 0.5
    p = {k: v.requires_grad_(True) for k, v in moe.shard_experts(draw_full(), mesh).items()}
    gc.collect()
    x.requires_grad_(True)
    names = ("router", "w_gate", "w_up", "w_down")

    def forward():
        with use_mesh(mesh):
            return moe.apply_moe(p, x, cfg, capacity_factor=DIST_TRAIN_CF)

    def backward(y, aux):
        return torch.autograd.grad(torch.sum(y * y) + aux, [p[k] for k in names] + [x])

    ops.reset_launch_counts()
    fwd_ms, bwd_ms = [], []
    for _ in range(1 + DIST_TRAIN_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = forward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = backward(y, aux)
        torch.cuda.synchronize()
        fwd_ms.append((t1 - t0) * 1e3)
        bwd_ms.append((time.perf_counter() - t1) * 1e3)
    fwd_busy = sum(g_["ms"] for g_ in profile_device(forward).values())
    yb, auxb = forward()
    bwd_busy = sum(g_["ms"] for g_ in profile_device(lambda: backward(yb, auxb)).values())
    del yb, auxb
    ep_launches = ops.launch_counts()
    y, aux = y.detach(), aux.detach()
    ep_grads = dict(zip(names, grads[:4]))
    gx = grads[4]
    del p, grads
    gc.collect()
    torch.cuda.empty_cache()

    # compressed_psum over the world group: each rank's gradients stand for
    # a data-parallel replica's; timed beside a plain fp32 all_reduce.  Over
    # gloo (which stages CUDA tensors through the host: 9.65 s for the
    # compressed and 6.77 s for the plain all-reduce of the whole 4.83 GB
    # tree per rank on an H100 80GB HBM3 at 700 W) only the router's and
    # w_down's gradients
    names_c = names if backend == "nccl" else ("router", "w_down")
    g_tree = {k: ep_grads[k] for k in names_c}
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    mean, ef = compressed_psum(g_tree, ef_init(g_tree), None, world)
    torch.cuda.synchronize()
    compress_ms = (time.perf_counter() - t0) * 1e3
    del ef
    plain = {k: v.clone() for k, v in g_tree.items()}
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for k in names_c:
        dist.all_reduce(plain[k])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    del plain
    # the one-rank reference from the gathered gradients: the same float32
    # steps (amax over every rank, int8 codes, their integer sum, the mean)
    compress_equal = True
    for k in names_c:
        parts = [torch.empty_like(g_tree[k]) for _ in range(world)]
        dist.all_gather(parts, g_tree[k].contiguous())
        amax = torch.stack([t.abs().max() for t in parts]).max()
        scale = torch.clamp(amax, min=1e-20) / torch.tensor(127.0, device=dev)
        total = sum(torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8).to(torch.int32) for t in parts)
        want = total.float() * scale / torch.tensor(float(world), device=dev)
        compress_equal &= bool(torch.equal(mean[k], want))
        del parts, total, want
    compress_launches = ops.launch_counts()
    n_grad_bytes = sum(v.numel() * 4 for v in g_tree.values())
    del mean
    gc.collect()
    torch.cuda.empty_cache()

    # the pipeline: one stage per rank (send / recv over NCCL)
    pipe = dist_pipeline(rank, world, cfg.d_model, dev) if backend == "nccl" else None

    # the same layer unsharded on this card (all experts, the whole batch),
    # one rank at a time so that two ranks on one card never hold it at once
    ref = None
    for r in range(world):
        if r == rank:
            pf = {k: v.requires_grad_(True) for k, v in draw_full().items()}
            xf = x.detach().clone().requires_grad_(True)
            cfg_dense = replace(cfg, moe_shardmap_dispatch=False)
            ops.reset_launch_counts()
            yf, auxf = moe.apply_moe(pf, xf, cfg_dense, capacity_factor=DIST_TRAIN_CF)
            gf = torch.autograd.grad(torch.sum(yf * yf) + auxf, [pf[k] for k in names] + [xf])
            lo = rank * e_loc
            ref = {"y": rel_to_magnitude(y, yf.detach()), "aux": rel_to_magnitude(aux, auxf.detach()),
                   "x": rel_to_magnitude(gx, gf[4]),
                   **{k: rel_to_magnitude(ep_grads[k], gf[i] if k == "router" else gf[i][lo:lo + e_loc])
                      for i, k in enumerate(names)},
                   "launches": ops.launch_counts()}
            del pf, xf, yf, auxf, gf
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    launches = {k: ep_launches[k] + compress_launches[k] + ref["launches"][k]
                + (pipe["launches"][k] if pipe else 0) for k in ep_launches}
    # bounds: the expert products (3 matmuls of 2 x rows x d x ff over this
    # rank's e_loc x C buffer rows) and this rank's expert weights read once
    # forward; twice the products, the weights read and their gradients
    # written backward; compressed_psum reads each gradient and writes the
    # mean and the residual (12 bytes an element)
    d, ff, C = cfg.d_model, cfg.moe_d_ff, moe.capacity(B * S, cfg, DIST_TRAIN_CF)
    flops = 3 * 2.0 * e_loc * C * d * ff
    w_bytes = 3.0 * e_loc * d * ff * 4
    bounds = {"ep_fwd": bound_ms(w_bytes, flops), "ep_bwd": bound_ms(2 * w_bytes, 2 * flops),
              "compress": bound_ms(3 * n_grad_bytes, 0.0)}
    return {"rank": rank, "world": world, "backend": backend, "card": torch.cuda.current_device(),
            "card_name": torch.cuda.get_device_name(dev), "mesh": {"data": 1, "model": world},
            "experts_per_rank": e_loc, "tokens": B * S, "capacity": C, "bounds_ms": bounds,
            "ep": {"fwd_wall_ms": fwd_ms[1:], "bwd_wall_ms": bwd_ms[1:], "fwd_busy_ms": fwd_busy,
                   "bwd_busy_ms": bwd_busy, "first_fwd_ms": fwd_ms[0], "first_bwd_ms": bwd_ms[0]},
            "compress": {"leaves": list(names_c), "ms": compress_ms, "plain_fp32_all_reduce_ms": plain_ms,
                         "grad_bytes": n_grad_bytes, "equal_to_one_rank_reference": compress_equal},
            "pipeline": pipe, "rel_err_vs_unsharded": {k: v for k, v in ref.items() if k != "launches"},
            "launches": launches, "peak_device_gb": torch.cuda.max_memory_allocated(dev) / 1e9}


def dist_pipeline(rank: int, world: int, d: int, dev) -> dict:
    """``pipeline_forward`` with this rank as one stage of ``world`` (d x d
    linear + tanh stages, DIST_PIPE_MICRO microbatches of DIST_PIPE_MB rows):
    the forward against the sequential stack, then its gradient (loss = sum
    of the outputs) against the sequential stack's autograd on this device:
    this stage's weight gradient and the input's (every rank's equal to
    stage 0's) relative to their magnitude, and the forward under autograd
    equal to the one without."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.training.pipeline import pipeline_forward

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def layer(w, h):
        return torch.tanh(h @ w)

    ws = torch.randn(world, d, d, generator=torch.Generator(device=dev).manual_seed(2), device=dev) / math.sqrt(d)
    xp = torch.randn(DIST_PIPE_MICRO, DIST_PIPE_MB, d, generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        out = pipeline_forward(layer, ws[rank], xp)
        sync()
        pipe_ms = (time.perf_counter() - t0) * 1e3
        seq = xp
        for s_ in range(world):
            seq = layer(ws[s_], seq)
    t0 = time.perf_counter()
    w_r, x_r = ws[rank].clone().requires_grad_(True), xp.clone().requires_grad_(True)
    out_g = pipeline_forward(layer, w_r, x_r)
    sync()
    t1 = time.perf_counter()
    out_g.sum().backward()
    sync()
    bwd_ms = (time.perf_counter() - t1) * 1e3
    ws_s, x_s = ws.clone().requires_grad_(True), xp.clone().requires_grad_(True)
    seq_g = x_s
    for s_ in range(world):
        seq_g = layer(ws_s[s_], seq_g)
    seq_g.sum().backward()
    grad = {"stage_weight_rel_err": rel_to_magnitude(w_r.grad, ws_s.grad[rank]),
            "input_rel_err": rel_to_magnitude(x_r.grad, x_s.grad),
            "forward_under_autograd_equal": bool(torch.equal(out_g.detach(), out)),
            "bwd_wall_ms": bwd_ms, "seconds": time.perf_counter() - t0}
    return {"stages": world, "micro": DIST_PIPE_MICRO, "mb": DIST_PIPE_MB, "d": d, "wall_ms": pipe_ms,
            "max_abs_err_vs_sequential": float((out - seq).abs().max()), "grad": grad,
            "launches": ops.launch_counts()}


def spawn_dist(world: int, backend: str, cards: list) -> list:
    """``world`` ranks over ``backend``, rank r on cuda:cards[r], spawned and
    joined with a timeout; their records in rank order."""
    import shutil

    import torch.multiprocessing as mp

    work = ROOT / "build" / f"dist_train_{backend}_{world}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.start_processes(_dist_rank, args=(world, backend, cards, str(work / "store"), str(work)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"dist_train: {world} {backend} ranks did not finish in {DIST_TIMEOUT_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]


def run_dist_train_path(dev) -> dict:
    """The training half of sharding on the card(s): (a) one rank per card
    over NCCL (min(cards, 4) ranks; world 1 on one card); (b) two ranks both
    on cuda:0 over gloo (NCCL refuses two ranks on one device; gloo stages
    CUDA all-reduces through the host), which runs the EP layer and
    compressed_psum but not the pipeline (gloo has no send / recv of CUDA
    tensors).  Each run: qwen3-moe-235b's MoE layer at full width through
    apply_moe_shardmap, forward and backward, held against the same layer
    unsharded on the card (outputs and every gradient within DIST_TRAIN_RTOL
    of their magnitude); compressed_psum over its gradients (over gloo the
    router's and w_down's) equal to a one-rank reference built from the
    gathered gradients, timed beside a plain fp32 all_reduce; the pipeline
    (NCCL) against the sequential stack, and its gradient (every stage's
    weight gradient and the input's, within DIST_TRAIN_RTOL of the
    sequential stack's autograd); no kernel launched
    (``ops.DIST_TRAIN_KERNELS`` is empty)."""
    import gc

    import torch

    from repro_torch.kernels import ops

    if ops.DIST_TRAIN_KERNELS:
        raise AssertionError(f"dist_train: the path lists kernels {ops.DIST_TRAIN_KERNELS}, want none")
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    n = min(cards, 4)
    runs = {"nccl": spawn_dist(n, "nccl", list(range(n))), "gloo_one_card": spawn_dist(2, "gloo", [0, 0])}
    launches = {k: 0 for k in ops.KERNEL_WRAPPERS}
    for name, recs in runs.items():
        for rec in recs:
            bad = {k: v for k, v in rec["rel_err_vs_unsharded"].items() if not v <= DIST_TRAIN_RTOL}
            if bad:
                raise AssertionError(f"dist_train {name} rank {rec['rank']}: beyond {DIST_TRAIN_RTOL} "
                                     f"of the unsharded layer: {bad}")
            if not rec["compress"]["equal_to_one_rank_reference"]:
                raise AssertionError(f"dist_train {name} rank {rec['rank']}: compressed_psum differs from "
                                     "the one-rank reference")
            if rec["pipeline"] and not rec["pipeline"]["max_abs_err_vs_sequential"] <= DIST_TRAIN_RTOL:
                raise AssertionError(f"dist_train {name}: pipeline off the sequential stack: {rec['pipeline']}")
            pg = rec["pipeline"]["grad"] if rec["pipeline"] else None
            if pg and not (pg["stage_weight_rel_err"] <= DIST_TRAIN_RTOL and pg["input_rel_err"] <= DIST_TRAIN_RTOL
                           and pg["forward_under_autograd_equal"]):
                raise AssertionError(f"dist_train {name} rank {rec['rank']}: the pipeline's gradient is off the "
                                     f"sequential stack's: {pg}")
            for k, v in rec["launches"].items():
                launches[k] += v
    if any(launches.values()):
        raise AssertionError(f"dist_train: kernels launched {launches}, want none")
    r0 = runs["nccl"][0]
    result = {"phase": "dist_train", "config": DIST_TRAIN_ARCH, "cards": cards,
              "runs": {name: {"backend": recs[0]["backend"], "ranks": len(recs),
                              "cards": sorted({rec["card"] for rec in recs}),
                              "pipeline_stages": recs[0]["pipeline"]["stages"] if recs[0]["pipeline"] else 0,
                              "records": recs} for name, recs in runs.items()},
              "launches": launches, "nvidia_smi": nvidia_smi_line(),
              "summary": {"nccl_ranks": len(runs["nccl"]), "ep_fwd_wall_ms": min(r0["ep"]["fwd_wall_ms"]),
                          "ep_fwd_busy_ms": r0["ep"]["fwd_busy_ms"], "ep_bwd_wall_ms": min(r0["ep"]["bwd_wall_ms"]),
                          "ep_bwd_busy_ms": r0["ep"]["bwd_busy_ms"], "compress_ms": r0["compress"]["ms"],
                          "plain_all_reduce_ms": r0["compress"]["plain_fp32_all_reduce_ms"],
                          "bounds_ms": r0["bounds_ms"],
                          "pipeline_stages": r0["pipeline"]["stages"],
                          "pipeline_grad": [{"rank": rec["rank"], **{k: rec["pipeline"]["grad"][k] for k in
                                                                    ("stage_weight_rel_err", "input_rel_err",
                                                                     "bwd_wall_ms", "seconds")}}
                                            for rec in runs["nccl"]]}}
    emit(result)
    print(f"dist_train: pipeline backward over {r0['pipeline']['stages']} stage(s): "
          + ", ".join(f"stage {g['rank']} weight grad rel err {g['stage_weight_rel_err']:.3e}, input grad "
                      f"{g['input_rel_err']:.3e}" for g in result["summary"]["pipeline_grad"]), flush=True)
    return result


def check_bf16_decode(dev) -> dict:
    """deepseek-7b's smoke config in its own dtype (bf16) through
    ``decode_step_ee`` with the kernels on the card against the CPU's plain
    path: six steps from an empty cache at full depth (threshold below
    every entropy) and exiting at layer 1 (above every one); exits equal,
    logits within 5e-2 of their magnitude and entropies within 5e-2 (bf16
    activations rounded by another matmul order on each side), the entropy
    kernel launched n_layers times per step on bf16 logits."""
    import numpy as np
    import torch

    from repro_torch.common.device import tree_to
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models.model import build_model, init_params

    cfg = get_smoke_config("deepseek_7b")
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_params = tree_to(params, dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(4, cfg.vocab_size, (2, 6)))
    out = {"phase": "bf16_decode", "config": cfg.name, "dtype": cfg.dtype, "runs": {}}
    for thr in (-1.0, 1e9):
        runs = {}
        for where, p, kernels in (("cpu", params, False), (dev, card_params, True)):
            cache = model.init_cache(2, 16, device=where)
            ops.reset_launch_counts()
            steps = []
            for t in range(tokens.shape[1]):
                pos = torch.full((2,), t, dtype=torch.int32, device=where)
                lg, cache, exit_layer, ent = model.decode_step_ee(p, cache, tokens[:, t:t + 1].to(where), pos, thr,
                                                                  use_kernels=kernels)
                steps.append((lg.float().cpu(), exit_layer.cpu(), ent.cpu()))
            runs[str(where)] = (steps, ops.launch_counts())
        (cpu, _), (card, launches) = runs["cpu"], runs[str(dev)]
        want = cfg.n_layers * tokens.shape[1]
        logit_err = max(float((lg - lc).abs().max() / lc.abs().max()) for (lc, _, _), (lg, _, _) in zip(cpu, card))
        ent_err = max(float((hg - hc).abs().max()) for (_, _, hc), (_, _, hg) in zip(cpu, card))
        exits_equal = all(torch.equal(eg, ec) for (_, ec, _), (_, eg, _) in zip(cpu, card))
        out["runs"][str(thr)] = {"logits_rel_err": logit_err, "entropy_abs_err": ent_err, "exits_equal": exits_equal,
                                 "launches": launches, "want_entropy_launches": want}
        if launches["softmax_entropy"] != want or any(v for k, v in launches.items() if k != "softmax_entropy"):
            raise AssertionError(f"bf16_decode: launches {launches}, want softmax_entropy {want} and nothing else")
        if not (exits_equal and logit_err <= 5e-2 and ent_err <= 5e-2):
            raise AssertionError(f"bf16_decode: card off the CPU: {out['runs'][str(thr)]}")
    emit(out)
    return out


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
    from repro_torch.kernels.span_attention import span_attention
    from repro_torch.models.model import init_params
    from repro_torch.serving.deploy import deploy_albert

    smi = nvidia_smi_line()
    dev = resolve_device("cuda")
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    # lm_train's dry-run traces (host only) beside the build and the deploy;
    # joined before the first timed phase
    dry_handles = spawn_dry_cells(LM_TRAIN_DRY_CELLS)
    try:
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
        t0 = time.perf_counter()
        dry_recs = join_dry_cells(dry_handles)
        dry_wait_s = time.perf_counter() - t0
    finally:
        stop_dry_cells(dry_handles)

    scfg = serving_config(cfg, span=False)
    sparams = serving_params(scfg, 0, prune=True)

    seconds: dict = {}
    long_by_phase: dict = {}

    def timed(name, fn, *args):
        t, n_long = time.perf_counter(), span_attention.long_launches
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        long_by_phase[name] = span_attention.long_launches - n_long
        return out

    rows = timed("kernel", check_kernels, dep, cfg, sparams, dev)
    timed("reference", check_reference, dep, params, cfg, dev)
    timed("serving_reference", check_serving_reference, scfg, sparams, dev)
    main_path = timed("main", run_main_path, dep, cfg, dev)
    serving = timed("serving", run_serving_path, scfg, sparams, dev)
    sharded = timed("sharded", run_sharded_path, scfg, sparams, dev, serving.pop("ctx"))
    replay = timed("replay", run_replay_path, scfg, dev)
    encoder = timed("encoder", run_encoder_path, dev)
    decode = timed("decode", run_decode_path, dev)
    moe_decode = timed("moe_decode", run_decode_path, dev, "qwen2_moe_a2p7b")
    ln_decode = timed("ln_decode", run_decode_path, dev, "minitron_8b")
    ssm_decode = timed("ssm_decode", run_ssm_decode_path, dev)
    hybrid_decode = timed("hybrid_decode", run_hybrid_decode_path, dev)
    encdec_decode = timed("encdec_decode", run_encdec_decode_path, dev)
    vlm_decode = timed("vlm_decode", run_vlm_decode_path, dev)
    lm_train = timed("lm_train", run_lm_train_path, dev, dry_recs)
    train = timed("train", run_train_path, dev)
    timed("bf16_decode", check_bf16_decode, dev)
    dist_train = timed("dist_train", run_dist_train_path, dev)
    seconds["eb_decode"] = decode["eb_decode"]["seconds"]        # within "decode"
    # lm_train's own dry-run trace, in a spawned process beside the build;
    # the wait for the traces after the build and the deploy
    seconds["lm_train_dryrun"] = lm_train["dryrun"]["seconds"]
    seconds["lm_train_dryrun_wait"] = dry_wait_s
    seconds["dist_train_pipeline_grad"] = max(g["seconds"] for g in dist_train["summary"]["pipeline_grad"])
    emit({"phase": "seconds", "by_phase": seconds})
    # the long-row span kernel engages only where calls meet its rule: the
    # encoder's global layers (whisper's encoder runs on the reference ops)
    emit({"phase": "span_long_launches", "by_phase": long_by_phase})
    if {k for k, n in long_by_phase.items() if n} != {"encoder"}:
        raise AssertionError(f"long-row span launches by phase {long_by_phase}: want the encoder phase's alone")
    for r in rows:
        by_path = {"deploy": main_path["launches"][r["name"]], "serving": serving["launches"][r["name"]],
                   "replay": replay["launches"][r["name"]], "encoder": encoder["launches"][r["name"]],
                   "decode": decode["launches"][r["name"]],
                   "eb_decode": decode["eb_decode"]["launches"][r["name"]],
                   "moe_decode": moe_decode["launches"][r["name"]], "ln_decode": ln_decode["launches"][r["name"]],
                   "ssm_decode": ssm_decode["launches"][r["name"]],
                   "hybrid_decode": hybrid_decode["launches"][r["name"]],
                   "encdec_decode": encdec_decode["launches"][r["name"]],
                   "vlm_decode": vlm_decode["launches"][r["name"]], "lm_train": lm_train["launches"][r["name"]],
                   "train": train["launches"][r["name"]], "dist_train": dist_train["launches"][r["name"]],
                   "dryrun": lm_train["dryrun"]["launches"][r["name"]],
                   # the sharded classifier drain and the sharded deepseek-7b
                   # W = 1 drain of the decode phase
                   "sharded": sharded["launches"][r["name"]] + decode["sharded"]["launches"][r["name"]]}
        # the launches of the path whose shapes the row was timed at: the
        # replay's, the deployed path's for af_matmul, which only that path
        # runs, or a decoder path's for the wide-row entropy and the
        # layernorm rows at d_model 4096 and 1024
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
