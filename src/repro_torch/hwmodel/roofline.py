"""Three-term roofline of a per-device step (the port of
``repro/hwmodel/roofline.py``).

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = HBM_bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The dry run (``launch/dryrun.py``) counts FLOPs, bytes and collective
bytes on each rank's local shards (``hwmodel/op_analysis.py``), so they are
per-device quantities; dividing by per-chip peaks gives seconds directly.

all-reduce traffic is weighted 2x (ring reduce-scatter + all-gather phases);
all-gather / reduce-scatter / all-to-all 1x of the LARGER (unsharded) side;
collective-permute (send / recv) 1x.  (n-1)/n ring factors are folded to 1.

The JAX package reads collective sizes out of XLA's HLO text
(``collective_bytes_from_hlo``); the port makes no HLO, so
``collective_bytes`` applies the same weights to the op analysis's record
of the collectives the step issued.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_bf16: float
    hbm_bw: float
    link_bw: float
    hbm_bytes: float


TPUV5E = ChipSpec(
    name="tpu_v5e",
    peak_flops_bf16=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    hbm_bytes=16 * 1024**3,
)

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s dense bf16
# (1979 with sparsity), 3.35 TB/s HBM3, 80 GB; NVLink 4 at 900 GB/s in both
# directions together (18 links x 25 GB/s each way), so 450e9 B/s one way.
# The compute and HBM peaks are the ones chip_smoke.py's bounds use.
H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_bf16=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)


def collective_bytes(records: Iterable[Mapping]) -> Dict[str, float]:
    """Per-device collective traffic by kind, weighted as the module doc
    says, from records ``{"kind": one of COLLECTIVE_KINDS, "bytes": the
    larger side's bytes}`` (``op_analysis.OpCosts.collectives``).  The keys
    are ``collective_bytes_from_hlo``'s: ``bytes_<kind>``, ``count_<kind>``
    and ``bytes_total``."""
    out = {k: 0.0 for k in COLLECTIVE_KINDS}
    counts = {k: 0 for k in COLLECTIVE_KINDS}
    for rec in records:
        kind = rec["kind"]
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}; known: {COLLECTIVE_KINDS}")
        weight = 2.0 if kind == "all-reduce" else 1.0
        out[kind] += weight * float(rec["bytes"])
        counts[kind] += 1
    res = {f"bytes_{k}": v for k, v in out.items()}
    res.update({f"count_{k}": float(v) for k, v in counts.items()})
    res["bytes_total"] = sum(out.values())
    return res


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """Useful-model FLOPs: 6ND train, 2ND forward/prefill/decode-token."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


def roofline_report(
    *,
    hlo_flops_per_device: float,
    hlo_bytes_per_device: float,
    collective_bytes_per_device: float,
    n_chips: int,
    model_flops_global: float,
    useful_bytes_per_device: float = 0.0,
    chip: ChipSpec = TPUV5E,
) -> Dict[str, float]:
    """Three roofline terms + efficiency of the DOMINANT term.

    The ``hlo_*`` arguments keep the JAX package's names: here they are the
    op analysis's per-device counts.

    roofline_fraction = (time the dominant resource would need for the
    *useful* work) / (time it needs for the work the program actually does).
    For compute-bound cells that is model_FLOPs/counted FLOPs; for
    memory-bound cells it is useful_bytes/counted bytes (useful bytes =
    params read once + mandatory state I/O, supplied by the caller); for
    collective-bound cells we report useful-flops-time/bound (no collective
    is "useful" in the 6ND sense).
    """
    t_compute = hlo_flops_per_device / chip.peak_flops_bf16
    t_memory = hlo_bytes_per_device / chip.hbm_bw
    t_coll = collective_bytes_per_device / chip.link_bw
    dominant = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_compute, t_memory, t_coll)
    hlo_flops_global = hlo_flops_per_device * n_chips
    useful_flops_ratio = (
        model_flops_global / hlo_flops_global if hlo_flops_global else 0.0
    )
    memory_efficiency = (
        useful_bytes_per_device / hlo_bytes_per_device if hlo_bytes_per_device else 0.0
    )
    if dominant == "compute":
        frac = useful_flops_ratio
    elif dominant == "memory":
        frac = memory_efficiency
    else:
        frac = (
            (model_flops_global / (n_chips * chip.peak_flops_bf16)) / bound
            if bound > 0 else 0.0
        )
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": bound,
        "model_flops": model_flops_global,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": useful_flops_ratio,
        "memory_efficiency": memory_efficiency,
        "roofline_fraction": frac,
        "n_chips": n_chips,
    }
