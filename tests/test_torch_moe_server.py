"""The MoE decoder through the DecoderServer, port against the JAX package.

The smoke ``qwen2_moe_a2p7b`` (2 layers, d_model 64, 6 experts top-2 with
a shared expert, qkv biases set to random nonzero values) in float32; the
JAX package initialises the params and the weight bridge carries them
across.  The JAX servers run their Pallas route in interpret mode, the
port's servers run on the CPU, where the kernel route takes the plain
versions.

Each drain runs in both packages with a shared-clock arbiter and per-token
exit, at 4 and at 8 lanes, spec windows 1 and 4.  At 8 lanes the capacity
of one routing over the lanes is 4, so the JAX package's prefill (every
lane stepped, token 0 outside the lane being filled) lets the dummy lanes
take the expert slots of lanes 4-7, and its per-lane decode keeps every
lane's assignments: the port must do both.  Generated tokens, exit depths,
integers and flags are equal; modeled floats (energies, clocks) within rel
1e-9; entropy traces and final logits within 1e-5.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.hwmodel.edgebert_accel import albert_layer_stats as j_stats
from repro.models.model import build_model as j_build
from repro.serving import dvfs as jdvfs
from repro.serving.engine import DecoderServer as JDecoder
from repro.serving.engine import Request as JRequest
from repro.serving.engine import probe_exit_threshold as j_probe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.launch import serve
from repro_torch.models import moe as tmoe
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import probe_exit_threshold as t_probe

ATOL = 1e-5
ARCH = "qwen2_moe_a2p7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _models():
    """(JAX model, params, port model, params, cfg): one JAX draw with
    random nonzero qkv biases, carried across."""
    if not _CACHE:
        jcfg, tcfg = (dataclasses.replace(get(ARCH), dtype="float32", remat_policy="none")
                      for get in (j_smoke, t_smoke))
        jm = j_build(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(1))
        r = np.random.default_rng(0)
        attn = dict(jp["layers"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray((0.5 * r.standard_normal(attn[name].shape)).astype(np.float32))
        jp = dict(jp, layers=dict(jp["layers"], attn=attn))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _CACHE.update(jax=(jm, jp), torch=(t_build(tcfg), tp), cfg=tcfg)
    return _CACHE


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, cfg.vocab_size, size=L).astype(np.int32) for L in lengths]


def _arbiter(pkg, n_layers):
    stats_fn, dvfs = (j_stats, jdvfs) if pkg == "jax" else (t_stats, tdvfs)
    stats = stats_fn(seq_len=16)
    stats.n_layers = n_layers
    ctrl = dvfs.LatencyAwareDVFSController(stats, dvfs.no_early_exit_baseline(stats)["latency_s"] * 2.0)
    return dvfs.BatchedDVFSArbiter(ctrl)


def _threshold(q=0.8):
    c = _models()
    jm, jp = c["jax"]
    return j_probe(jm, jp, _prompts(c["cfg"], (6, 5, 7, 4, 6)), max_new_tokens=4, quantile=q)


def _drain(pkg, prompts, *, lanes, W=1, thr=None, arbiter=True, new=4):
    c = _models()
    model, params = c[pkg]
    Decoder, Request = (JDecoder, JRequest) if pkg == "jax" else (TDecoder, TRequest)
    kw = {"use_pallas": True} if pkg == "jax" else {"device": "cpu"}
    srv = Decoder(model, params, batch_lanes=lanes, max_seq=32, eos_id=-1, buckets=(16,),
                  exit_threshold=thr, spec_window=W,
                  arbiter=_arbiter(pkg, c["cfg"].n_layers) if arbiter else None, **kw)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, tokens=p, max_new_tokens=new))
    srv.run()
    return srv


REQ_INT = ("uid", "bucket", "preempted", "ckpt_depth", "arrival_step", "first_compute_step", "retire_step")
REQ_FLOAT = ("deadline_s", "arrival_s", "admit_s", "retire_s", "energy_j", "latency_s", "op_vdd", "op_freq_hz")


def _same_float(a, b, path):
    if a is None or b is None:
        assert a is None and b is None, path
    else:
        assert math.isclose(float(a), float(b), rel_tol=1e-9, abs_tol=0.0), (path, a, b)


def assert_same(a, b, path="out"):
    """Integers, flags, strings and None equal; floats within rel 1e-9."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) or isinstance(b, (float, np.floating)):
        _same_float(a, b, path)
    else:
        assert a == b, (path, a, b)


def assert_same_servers(js, ts):
    """Telemetry, and per request its tokens, exits, lifecycle stamps and
    modeled energy; entropy traces and final logits within 1e-5."""
    assert_same(js.telemetry(), ts.telemetry())
    assert sorted(js.done) == sorted(ts.done)
    for uid in js.done:
        a, b = js.done[uid], ts.done[uid]
        assert a.generated == b.generated, uid
        assert a.token_exit_layers == b.token_exit_layers, uid
        for f in REQ_INT:
            assert getattr(a, f) == getattr(b, f), (uid, f)
        for f in REQ_FLOAT:
            _same_float(getattr(a, f), getattr(b, f), (uid, f))
        np.testing.assert_allclose(b.entropy_trace, a.entropy_trace, atol=ATOL, rtol=0)
        assert (a.result is None) == (b.result is None), uid
        if a.result is not None:
            np.testing.assert_allclose(b.result, np.asarray(a.result), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# drains
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanes", [4, 8])
@pytest.mark.parametrize("W", [1, 4])
def test_moe_drain_matches_jax(lanes, W):
    """12 requests of 3-9 prompt tokens through 4 or 8 lanes (refills, so
    prefills into half-busy caches), per-token exit, an arbiter, spec
    window 1 or 4."""
    cfg = _models()["cfg"]
    thr = _threshold()
    prompts = _prompts(cfg, (6, 5, 7, 4, 9, 3, 6, 8, 5, 7, 4, 6), seed=2)
    js = _drain("jax", prompts, lanes=lanes, W=W, thr=thr)
    ts = _drain("torch", prompts, lanes=lanes, W=W, thr=thr)
    assert_same_servers(js, ts)
    st = ts.telemetry()
    assert st["completed"] == len(prompts)
    assert st["decode_traces"] == 1 and st["prefill_traces"] == 1
    assert st["accepted_slo_misses"] == 0 and all(r.energy_j > 0 for r in ts.done.values())
    exits = {x for r in ts.done.values() for x in r.token_exit_layers}
    assert exits <= {1, 2}
    if W > 1:
        assert st["tokens_per_fused_step"] >= 1.0


def test_spec_window_four_equals_one_bitwise_in_the_port():
    """Every speculative slot is the same per-lane decode_step_ee at the
    same shapes: W = 4's tokens, exits and final logits equal W = 1's bit
    for bit, at 4 lanes.  (At 8 lanes the reference's own prefill makes a
    request's cache depend on the lane it lands in, lanes 4-7 losing expert
    slots to the dummy lanes, and W = 4 refills other lanes than W = 1: both
    packages then differ between the windows, the same way, as
    test_moe_drain_matches_jax shows.)"""
    cfg = _models()["cfg"]
    thr = _threshold()
    prompts = _prompts(cfg, (6, 5, 7, 4, 9, 3, 6, 8, 5, 7, 4, 6), seed=2)
    s1, s4 = (_drain("torch", prompts, lanes=4, W=W, thr=thr) for W in (1, 4))
    for i in s1.done:
        assert s4.done[i].generated == s1.done[i].generated
        assert s4.done[i].token_exit_layers == s1.done[i].token_exit_layers
        np.testing.assert_array_equal(s4.done[i].result, s1.done[i].result)
    assert s4.telemetry()["tokens_per_fused_step"] > 1.0


def test_identical_lanes_keep_every_assignment():
    """Eight requests with the same one-token prompt (no prefill step, so
    nothing couples the lanes before decode) put eight identical tokens
    into one fused step.  Routed together they would overflow the capacity
    of 4 and lanes 4-7 would lose their experts; routed per lane, as the
    JAX package's lane vmap does, every lane equals a one-lane drain."""
    cfg = _models()["cfg"]
    assert 8 > tmoe.capacity(8, cfg)
    thr = _threshold()
    prompts = [np.array([123], np.int32)] * 8
    ts = _drain("torch", prompts, lanes=8, thr=thr, new=5)
    alone = _drain("torch", prompts[:1], lanes=1, thr=thr, new=5).done[0]
    for r in ts.done.values():
        assert r.generated == alone.generated and r.token_exit_layers == alone.token_exit_layers
        np.testing.assert_allclose(r.result, alone.result, atol=ATOL, rtol=0)
    assert_same_servers(_drain("jax", prompts, lanes=8, thr=thr, new=5), ts)


def test_full_depth_drain_matches_jax():
    """No exit threshold: the plain decode step, 8 lanes, no arbiter."""
    cfg = _models()["cfg"]
    prompts = _prompts(cfg, (6, 5, 7, 4, 9, 3, 6, 8, 5), seed=4)
    assert_same_servers(_drain("jax", prompts, lanes=8, arbiter=False),
                        _drain("torch", prompts, lanes=8, arbiter=False))


def test_probe_exit_threshold():
    c = _models()
    prompts = _prompts(c["cfg"], (6, 5, 7, 4, 6))
    got = [t_probe(*c["torch"], prompts, max_new_tokens=4, quantile=q, device="cpu") for q in (0.3, 0.8)]
    want = [j_probe(*c["jax"], prompts, max_new_tokens=4, quantile=q) for q in (0.3, 0.8)]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_serve_launcher_moe_branch():
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3", "--max-new-tokens", "2",
                        "--threshold", "100.0"])
    assert stats["completed"] == 3 and stats["tokens"] == 6 and stats["avg_token_exit_layer"] == 1.0
