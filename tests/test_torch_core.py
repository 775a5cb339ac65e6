"""Parity of the port's core numerics (``repro_torch.core``, configs, the
DVFS controller) with the JAX package, on the same numpy inputs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import adaptivfloat as jaf
from repro.core import early_exit as jee
from repro.core import envm as jenvm
from repro.core.adaptive_span import active_head_indices as j_active
from repro.core.adaptive_span import hard_spans as j_hard
from repro.core.entropy import entropy_from_logits as j_entropy
from repro.serving import dvfs as jdvfs
from repro_torch.configs import base as tcfg
from repro_torch.core import adaptivfloat as taf
from repro_torch.core import early_exit as tee
from repro_torch.core import envm as tenvm
from repro_torch.core.adaptive_span import active_head_indices as t_active
from repro_torch.core.adaptive_span import hard_spans as t_hard
from repro_torch.core.entropy import entropy_from_logits as t_entropy
from repro_torch.serving import dvfs as tdvfs


def _binade_edges(lo: int, hi: int) -> np.ndarray:
    """2^k and the float32 neighbours just below and above, for k in [lo, hi]."""
    p = np.exp2(np.arange(lo, hi + 1, dtype=np.float64)).astype(np.float32)
    return np.concatenate([p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf))])


def _af_inputs():
    """Seeded tensors whose amax sits at, just below and just above 2^k (the
    per-tensor bias comes from floor(log2(amax))), with elements on binade
    edges, near the zero/min-positive cut-offs and past saturation.

    2^13 itself is in: the reference's log2 puts it in binade 12."""
    rng = np.random.default_rng(0)
    cases = []
    for amax in [*_binade_edges(-4, 12), np.float32(2.0 ** 13)]:
        x = rng.standard_normal(257).astype(np.float32)
        x = x / np.abs(x).max() * amax
        x[:3] = [amax, -amax, 0.0]
        # elements on the binades below amax's, and their neighbours
        e_max = int(np.floor(np.log2(np.float64(amax))))
        edges = _binade_edges(e_max - 8, e_max - 1)
        cases.append(np.concatenate([x, edges, -edges]))
    n = len(cases[0])       # one length for every case: JAX compiles each op once
    for scale in (0.02, 0.125, 1.0, 50.0):
        cases.append((rng.standard_normal(n) * scale).astype(np.float32))
    return cases


AF_INPUTS = _af_inputs()
FORMATS = [(8, 3), (6, 3), (5, 2), (8, 4)]


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_af_encode_codes_and_bias_equal(fmt):
    """Codes and e_min equal to JAX's, including binade edges (exact: the
    codes are what the eNVM stores and the kernels decode)."""
    jf, tf = jaf.AFFormat(*fmt), taf.AFFormat(*fmt)
    for x in AF_INPUTS:
        jc, je = jaf.af_encode(jnp.asarray(x), jf)
        tc, te = taf.af_encode(torch.from_numpy(x), tf)
        assert int(te) == int(je), (x.max(), int(te), int(je))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_floor_log2_matches_reference_near_binade_edges():
    """Every float32 within 64 ulp of 2^k for k in [-60, 60], plus seeded
    values: the port's floor(log2) equals the reference's exactly (the
    reference's log2 is not correctly rounded at powers of two).  Outside
    that range one value is known to differ: 13 ulp below 2^94, where XLA's
    log and PyTorch's differ in the last ulp (ROADMAP, Queue 3)."""
    base = np.exp2(np.arange(-60, 61, dtype=np.float64)).astype(np.float32).view(np.int32)
    x = (base[:, None] + np.arange(-64, 65, dtype=np.int32)[None, :]).reshape(-1).view(np.float32)
    x = np.concatenate([x, np.abs(np.random.default_rng(9).standard_normal(4096)).astype(np.float32) + 1e-3])
    want = np.floor(np.asarray(jnp.log2(jnp.asarray(x))))
    got = taf.floor_log2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_reference_exp2_exact_on_the_tested_exponents():
    """The premise of the bit-exact decode/quantize tests: the reference's
    exp2 of an integer in [-12, 12] is the exact power of two."""
    k = np.arange(-12, 13, dtype=np.float32)
    got = taf.exact_pow2(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(np.asarray(jnp.exp2(jnp.asarray(k))), got)
    np.testing.assert_array_equal(got, np.exp2(k.astype(np.float64)).astype(np.float32))


def _binades_in_exact_range(x, fmt) -> bool:
    """Whether every binade the format gives x has an exponent in [-12, 12],
    where the reference's exp2 is exact (see repro_torch.core.adaptivfloat)."""
    e_min = int(jaf.af_encode(jnp.asarray(x), fmt)[1])
    return e_min >= -12 and e_min + fmt.n_levels_exp - 1 <= 12


@pytest.mark.parametrize("fmt", FORMATS, ids=str)
def test_af_quantize_bit_exact(fmt):
    jf, tf = jaf.AFFormat(*fmt), taf.AFFormat(*fmt)
    cases = [x for x in AF_INPUTS if _binades_in_exact_range(x, jf)]
    assert len(cases) >= 20
    for x in cases:
        want = np.asarray(jaf.af_quantize(jnp.asarray(x), jf))
        got = taf.af_quantize(torch.from_numpy(x), tf).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("e_min", range(-12, 5))
def test_af_decode_bit_exact_all_codes(e_min):
    """Every uint8 code, compared as bits (sign of zero included).  e_min
    spans the exponents where the reference's exp2 is exact; see
    repro_torch.core.adaptivfloat for the range outside it."""
    codes = np.arange(256, dtype=np.uint8)
    for fmt in FORMATS:
        if e_min + 2 ** fmt[1] - 1 > 12:
            continue
        want = np.asarray(jaf.af_decode(jnp.asarray(codes), jnp.int32(e_min), jaf.AFFormat(*fmt)))
        got = taf.af_decode(torch.from_numpy(codes), e_min, taf.AFFormat(*fmt)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_entropy_matches():
    """Entropy within 1e-6: the same float32 ops, the exponentials and logs
    of two libraries differing in the last ulp."""
    x = (np.random.default_rng(1).standard_normal((64, 7)) * 4).astype(np.float32)
    want = np.asarray(j_entropy(jnp.asarray(x)))
    got = t_entropy(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_hard_spans_and_active_heads_equal():
    z = np.asarray([0.0, 0.4, 0.5, 3.2, 64.0, 127.9, 0.49, 12.0], np.float32)
    np.testing.assert_array_equal(t_hard(z), j_hard(z))
    np.testing.assert_array_equal(t_hard(z, threshold=4.0), j_hard(z, threshold=4.0))
    for spans in ([16, 0, 0, 40, 75, 0, 2], [0, 0, 0], [64] * 12):
        ti, tw = t_active(spans)
        ji, jw = j_active(spans)
        np.testing.assert_array_equal(ti, ji)
        assert tw == jw


@pytest.mark.parametrize("cell", ["SLC", "MLC2"])
@pytest.mark.parametrize("seed", [0, 1])
def test_envm_readback_bit_identical(cell, seed):
    """A table shaped like the smoke vocab x embed (512 x 32), 60% pruned:
    the readback and the fault statistics are identical to the JAX package's."""
    rng = np.random.default_rng(100 + seed)
    table = (rng.standard_normal((512, 32)) * 0.02).astype(np.float32)
    table[rng.random(table.shape) < 0.6] = 0.0
    want, jstats = jenvm.store_and_readback(table, data_cell=cell, seed=seed)
    got, tstats = tenvm.store_and_readback(table, data_cell=cell, seed=seed)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert tstats == jstats


def test_mlc3_faults_identical():
    """MLC3's error rate is high enough that faults really land, so the
    injection order (not just the no-fault path) is what is compared."""
    table = (np.random.default_rng(7).standard_normal((256, 32)) * 0.5).astype(np.float32)
    want, jstats = jenvm.store_and_readback(table, data_cell="MLC3", seed=3)
    got, tstats = tenvm.store_and_readback(table, data_cell="MLC3", seed=3)
    assert jstats["n_code_faults"] > 0
    np.testing.assert_array_equal(got, want)
    assert tstats == jstats


def test_offramp_and_exit_decisions_match():
    rng = np.random.default_rng(2)
    d, C, B, S, L = 16, 3, 5, 7, 4
    arrs = [rng.standard_normal(s).astype(np.float32) for s in ((d, d), (d,), (d, C), (C,))]
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    want = np.asarray(jee.offramp_logits(jnp.asarray(h), jee.OfframpParams(*map(jnp.asarray, arrs))))
    got = tee.offramp_logits(torch.from_numpy(h), tee.OfframpParams(*map(torch.from_numpy, arrs)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)   # float32 matmul order

    ent = rng.uniform(0.0, 1.1, (L, B)).astype(np.float32)
    jl, joh = jee.exit_decisions(jnp.asarray(ent), 0.3)
    tl, toh = tee.exit_decisions(torch.from_numpy(ent), 0.3)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(toh.numpy(), np.asarray(joh))
    logits = rng.standard_normal((L, B, C)).astype(np.float32)
    np.testing.assert_array_equal(
        tee.select_exit_logits(torch.from_numpy(logits), tl).numpy(),
        np.asarray(jee.select_exit_logits(jnp.asarray(logits), jl)),
    )


def test_exit_predictors_match():
    rng = np.random.default_rng(3)
    e = rng.uniform(0.2, 1.1, 200)
    x = rng.integers(1, 13, 200)
    for q in (None, 0.9, 1.0):
        jp, tp = jee.fit_exit_predictor(e, x, quantile=q), tee.fit_exit_predictor(e, x, quantile=q)
        np.testing.assert_array_equal(tp.bin_edges, jp.bin_edges)
        np.testing.assert_array_equal(tp.bin_exit, jp.bin_exit)
        for v in (0.0, 0.5, 0.77, 2.0):
            assert tee.predict_exit_layer(tp, v) == jee.predict_exit_layer(jp, v)
    jc, tc = jee.OnlineExitCalibrator(12, window=8), tee.OnlineExitCalibrator(12, window=8)
    for ei, xi in zip(e, x):
        jc.observe(ei, int(xi))
        tc.observe(ei, int(xi))
        assert tc.predict(ei) == jc.predict(ei)
    np.testing.assert_array_equal(tc.predictor().bin_exit, jc.predictor().bin_exit)


def test_dvfs_controller_reports_identical():
    """Pure numpy/Python: identical reports for identical entropy traces."""
    rng = np.random.default_rng(4)
    e = rng.uniform(0.1, 1.1, 300)
    x = rng.integers(1, 13, 300)
    target = jdvfs.no_early_exit_baseline(jdvfs.albert_layer_stats())["latency_s"] * 0.8
    assert tdvfs.no_early_exit_baseline(tdvfs.albert_layer_stats()) == jdvfs.no_early_exit_baseline(
        jdvfs.albert_layer_stats()
    )
    jc = jdvfs.default_albert_controller(target, predictor=jee.fit_exit_predictor(e, x, quantile=0.9))
    tc = tdvfs.default_albert_controller(target, predictor=tee.fit_exit_predictor(e, x, quantile=0.9))
    assert tc.no_early_exit_baseline() == jc.no_early_exit_baseline()
    for _ in range(50):
        n = int(rng.integers(1, 13))
        trace = list(rng.uniform(0.0, 1.1, n))
        deadline = None if rng.random() < 0.5 else float(target * rng.uniform(0.3, 1.5))
        want = jc.sentence_report(trace, target_latency_s=deadline)
        got = tc.sentence_report(trace, target_latency_s=deadline)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", ["albert_base", "albert_edgebert"])
def test_configs_are_copies(arch):
    assert tcfg.jax_fields(tcfg.get_config(arch)) == dataclasses.asdict(jcfg.get_config(arch))
    assert tcfg.jax_fields(tcfg.get_smoke_config(arch)) == dataclasses.asdict(
        jcfg.get_smoke_config(arch)
    )
    assert tcfg.get_config(arch).num_params() == jcfg.get_config(arch).num_params()
