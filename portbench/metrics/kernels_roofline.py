"""Kernels: the port's kernel calls in the traced window, the sum of each
call's least time (its operations at the bf16 peak or its bytes at the HBM
rate, whichever is larger: ``work.albert_step_kernel_work``, from the
step's shapes) over the sum of their device time, in %.  The fused steps
counted are those inside the traced window."""
from portbench import peaks, work

# the port's kernels by the names their device functions carry
SYMBOLS = {
    "layernorm_kernel": "layernorm",
    "af_quantize_groups_kernel": "af_quantize",
    "span_attention_kernel": "span_attention",
    "block_sparse_kernel": "block_sparse_matmul",
    "offramp_head_kernel": "softmax_entropy",
}


def read(ctx):
    t, hooks = ctx["trace"], ctx["hooks"]
    if t is None or hooks is None or ctx["cfg"]["family"] != "albert":
        return None
    lo, hi = t["lo_ns"], t["hi_ns"]
    dev = sum((b - a) / 1e9 for a, b, n in t["ops"] if any(k in n for k in SYMBOLS))
    m, dens = ctx["cfg"]["model"], ctx["fam"].density(ctx["cfg"])
    least = 0.0
    for s in hooks.steps:
        if lo <= s["t0"] and s["t1"] <= hi:
            for flops, nbytes in work.albert_step_kernel_work(m, s["bucket"], s["lane_len"], dens).values():
                least += peaks.roofline_s(flops, nbytes)
    return 100.0 * least / dev if dev > 0 and least > 0 else None
