"""The port's roofline (``hwmodel/roofline.py``) and op analysis
(``hwmodel/op_analysis.py``) against the JAX package's ``roofline.py`` and
``hlo_analysis.py``.

The roofline cases are ``tests/test_hwmodel.py``'s, run through both
packages and compared dict for dict; the HLO collective case becomes the
same collectives as the port's records.  The op analysis counts the same
matmul FLOPs as ``hlo_analysis.analyze`` of the compiled JAX program on a
10-trip matmul loop, 3 x 5 nested loops and the gradient of
``sum(tanh(a @ b))``: the JAX side a ``lax.scan``, the port's a Python
loop, both on shapes alone (``ShapeDtypeStruct``s; meta tensors).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.hwmodel import roofline as jroof
from repro.hwmodel.hlo_analysis import analyze as hlo_analyze
from repro_torch.hwmodel import roofline as troof
from repro_torch.hwmodel.op_analysis import OpAnalysis, OpCosts, analyze, scope

ROOFLINE_CASES = {
    "dominance": dict(hlo_flops_per_device=197e12, hlo_bytes_per_device=819e9 / 2,
                      collective_bytes_per_device=5e9, n_chips=256, model_flops_global=197e12 * 256),
    "memory_dominant": dict(hlo_flops_per_device=1e9, hlo_bytes_per_device=819e9, collective_bytes_per_device=0,
                            n_chips=4, model_flops_global=4e9, useful_bytes_per_device=819e9 / 4),
    "collective_dominant": dict(hlo_flops_per_device=1e9, hlo_bytes_per_device=1e6,
                                collective_bytes_per_device=1e12, n_chips=16, model_flops_global=8e9),
    "empty": dict(hlo_flops_per_device=0.0, hlo_bytes_per_device=0.0, collective_bytes_per_device=0.0,
                  n_chips=1, model_flops_global=0.0),
}


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_report_equals_jax(case):
    """``test_hwmodel.py``'s cases (and a collective-bound and an empty one)
    on the TPU v5e spec: the same dict."""
    kw = ROOFLINE_CASES[case]
    assert troof.roofline_report(**kw) == jroof.roofline_report(**kw)


@pytest.mark.parametrize("case", sorted(ROOFLINE_CASES))
def test_roofline_report_on_h100_equals_jax_with_the_same_spec(case):
    kw = ROOFLINE_CASES[case]
    h = troof.H100_SXM
    jspec = jroof.ChipSpec(h.name, h.peak_flops_bf16, h.hbm_bw, h.link_bw, h.hbm_bytes)
    assert troof.roofline_report(**kw, chip=h) == jroof.roofline_report(**kw, chip=jspec)


def test_dominance_and_fractions():
    """``test_hwmodel.py::TestRoofline``' assertions on the port."""
    r = troof.roofline_report(**ROOFLINE_CASES["dominance"])
    assert r["dominant"] == "compute" and abs(r["t_compute_s"] - 1.0) < 1e-9
    assert abs(r["roofline_fraction"] - 1.0) < 1e-9
    r = troof.roofline_report(**ROOFLINE_CASES["memory_dominant"])
    assert r["dominant"] == "memory" and abs(r["roofline_fraction"] - 0.25) < 1e-9


def test_model_flops_equals_jax():
    for kind in ("train", "prefill", "decode"):
        assert troof.model_flops(1e9, 1e6, kind) == jroof.model_flops(1e9, 1e6, kind)
    assert troof.model_flops(1e9, 1e6, "train") == 6e15


def test_specs():
    """TPU v5e as the JAX package has it; the H100 SXM at its datasheet
    peaks (dense bf16, HBM3, NVLink 4 one way, 80 GB)."""
    assert troof.TPUV5E == troof.ChipSpec(**vars(jroof.TPUV5E))
    h = troof.H100_SXM
    assert (h.peak_flops_bf16, h.hbm_bw, h.link_bw, h.hbm_bytes) == (989e12, 3.35e12, 450e9, 80e9)
    src = open(troof.__file__).read()
    assert "H100 Tensor Core GPU datasheet" in src and "NVLink 4" in src


def test_collective_bytes_equals_the_hlo_parse():
    """``test_hwmodel.py::test_collective_regex``' HLO (an all-reduce of
    bf16[1024], an all-gather to f32[64, 32] and an all-gather-done that
    is not counted) against the same collectives as records."""
    hlo = """
  %all-reduce.1 = bf16[1024]{0} all-reduce(%x), replica_groups={}
  %ag = f32[64,32]{1,0} all-gather(%y), dimensions={0}
  %done = f32[8]{0} all-gather-done(%z)
"""
    recs = [{"kind": "all-reduce", "bytes": 1024 * 2}, {"kind": "all-gather", "bytes": 64 * 32 * 4}]
    assert troof.collective_bytes(recs) == jroof.collective_bytes_from_hlo(hlo)
    with pytest.raises(ValueError, match="unknown collective"):
        troof.collective_bytes([{"kind": "gossip", "bytes": 1}])


# ---------------------------------------------------------------------------
# The op analysis against hlo_analysis
# ---------------------------------------------------------------------------


def _jax_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return hlo_analyze(jax.jit(f).lower(*args).compile().as_text()).flops


def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_loop_flops_equal_hlo_analysis():
    def jf(x, w):
        return jax.lax.scan(lambda h, _: (h @ w, None), x, None, length=10)[0]

    def tf(x, w):
        for _ in range(10):
            x = x @ w
        return x

    _, costs = analyze(tf, _meta(128, 256), _meta(256, 256))
    assert costs.flops == _jax_flops(jf, (128, 256), (256, 256)) == 2 * 128 * 256 * 256 * 10
    assert (costs.n_while, costs.max_trip) == (0, 1)
    assert costs.ops["mm"]["count"] == 10


def test_nested_loop_flops_equal_hlo_analysis():
    def jf(x, w):
        def outer(h, _):
            return jax.lax.scan(lambda hh, _: (hh @ w, None), h, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    def tf(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x

    _, costs = analyze(tf, _meta(64, 64), _meta(64, 64))
    assert costs.flops == _jax_flops(jf, (64, 64), (64, 64)) == 2 * 64 * 64 * 64 * 15


def test_grad_flops_equal_hlo_analysis():
    """Forward and both backward matmuls of sum(tanh(a @ b))."""
    jf = jax.grad(lambda a, b: jnp.sum(jnp.tanh(a @ b)), argnums=(0, 1))

    def tf(a, b):
        return torch.autograd.grad(torch.tanh(a @ b).sum(), (a, b))

    _, costs = analyze(tf, _meta(32, 64, grad=True), _meta(64, 16, grad=True))
    assert costs.flops == _jax_flops(jf, (32, 64), (64, 16)) == 3 * 2 * 32 * 64 * 16


def test_bytes_rule():
    """Inputs once, each compute result twice, views and allocations free,
    a partial in-place write its update; the table sorts by bytes."""
    x, w = _meta(8, 16), _meta(16, 4)

    def f(x, w):
        y = (x @ w).t().contiguous()          # mm: 2 x 128 B; t: a view; contiguous: a copy
        buf = torch.empty(4, 100, device="meta")   # an allocation: free
        buf[:, :8].copy_(y)                   # pays the update, 2 x 128 B
        return torch.tanh(buf)                # 2 x 1600 B

    _, costs = analyze(f, x, w)
    assert costs.bytes_io == (8 * 16 + 16 * 4) * 4 + 3 * 2 * 8 * 4 * 4 + 2 * 4 * 100 * 4
    assert costs.table()[0] == {"op": "tanh", "count": 1, "flops": 0.0, "bytes": 3200.0}
    assert costs.ops["mm"] == {"count": 1, "flops": 2 * 8 * 16 * 4, "bytes": 256.0}
    assert "t" not in costs.ops and "empty" not in costs.ops and "slice" not in costs.ops


def test_scope_labels_ops():
    with OpAnalysis() as mode:
        a = _meta(4, 4)
        with scope("fused_attn_kernel"):
            a @ a
        a @ a
    assert mode.costs.ops["fused_attn_kernel/mm"]["count"] == 1 and mode.costs.ops["mm"]["count"] == 1


def test_op_costs_fields_are_hlo_costs_fields():
    from dataclasses import fields

    from repro.hwmodel.hlo_analysis import HloCosts

    assert [f.name for f in fields(HloCosts)] == [f.name for f in fields(OpCosts)][:len(fields(HloCosts))]
