"""The RWKV6 (ssm) decoder and the LayerNorm decoder (minitron-8b) through
the DecoderServer, port against the JAX package.

The smoke ``rwkv6_7b`` and ``minitron_8b`` configs in float32; the JAX
package initialises the params and the weight bridge carries them across.
The JAX servers run their Pallas route in interpret mode (rwkv6's final
LayerNorm, minitron-8b's pre-norms, final norms and LM-head entropy); the
port's run on the CPU, where the kernel route takes the plain versions.

At refill the port zeroes a lane's recurrent state before the new
request's prefill; the JAX server carries the state the lane's previous
request left behind into it.  So the drains are held against the JAX
server where every request is the first in its lane (lanes >= requests),
and against the JAX model's own ``init_cache`` -> ``prefill`` ->
``decode_step`` for every request; ``test_refill_does_not_carry_the_lane
_history`` shows the reference's carry and the port's independence of it.

Generated tokens, exit depths, integers and flags equal; modeled floats
(energies, clocks) within rel 1e-9; entropy traces and final logits within
1e-5.
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
from repro.serving import residency as jres
from repro.serving.engine import DecoderServer as JDecoder
from repro.serving.engine import Request as JRequest
from repro.serving.engine import probe_exit_threshold as j_probe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.hwmodel.edgebert_accel import albert_layer_stats as t_stats
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving import residency as tres
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _models(arch, seed=1):
    """{"jax": (model, params), "torch": (model, params), "cfg": cfg}: one
    JAX draw per (arch, seed), carried across."""
    key = (arch, seed)
    if key not in _CACHE:
        jcfg, tcfg = (dataclasses.replace(get(arch), dtype="float32", remat_policy="none")
                      for get in (j_smoke, t_smoke))
        jm = j_build(jcfg)
        jp = jm.init_params(jax.random.PRNGKey(seed))
        tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _CACHE[key] = {"jax": (jm, jp), "torch": (t_build(tcfg), tp), "cfg": tcfg}
    return _CACHE[key]


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, cfg.vocab_size, size=L).astype(np.int32) for L in lengths]


def _arbiter(pkg, n_layers):
    stats_fn, dvfs = (j_stats, jdvfs) if pkg == "jax" else (t_stats, tdvfs)
    stats = stats_fn(seq_len=16)
    stats.n_layers = n_layers
    return dvfs.BatchedDVFSArbiter(dvfs.LatencyAwareDVFSController(
        stats, dvfs.no_early_exit_baseline(stats)["latency_s"] * 2.0))


def _drain(pkg, arch, prompts, *, lanes, W=1, thr=None, arbiter=False, residency=False, new=5, seed=1):
    c = _models(arch, seed)
    model, params = c[pkg]
    Decoder, Request, res = (JDecoder, JRequest, jres) if pkg == "jax" else (TDecoder, TRequest, tres)
    kw = {"use_pallas": True} if pkg == "jax" else {"device": "cpu"}
    if residency:
        kw.update(task="lm", residency=res.TaskResidencyManager(
            [res.TaskDeployment("lm", n_params=2e5)], sram_bytes=1e9))
    if W > 1:
        kw.update(spec_window=W)
    srv = Decoder(model, params, batch_lanes=lanes, max_seq=32, eos_id=-1, buckets=(16,), exit_threshold=thr,
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


# telemetry the port keeps and the JAX package has no counterpart of: the
# blocking copies between host and card
PORT_ONLY = ("host_syncs",)


def assert_same(a, b, path="out"):
    """Integers, flags, strings and None equal; floats within rel 1e-9
    (``a`` the JAX package's, ``b`` the port's less its ``PORT_ONLY``
    keys)."""
    if isinstance(a, dict):
        if isinstance(b, dict):
            b = {k: v for k, v in b.items() if k not in PORT_ONLY}
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


def _greedy_jax_model(arch, prompt, new, seed=1):
    """The JAX model's own contract: a fresh one-lane ``init_cache``, the
    prompt but its last token through ``prefill``, then ``decode_step``
    from the last token, greedy."""
    jm, jp = _models(arch, seed)["jax"]
    cache = jm.init_cache(1, 32)
    _, cache = jm.prefill(jp, jnp.asarray(prompt[None, :-1]), cache)
    tok, out = int(prompt[-1]), []
    for t in range(new):
        lg, cache = jm.decode_step(jp, cache, jnp.asarray([[tok]]), len(prompt) - 1 + t)
        tok = int(np.asarray(lg)[0, -1].argmax())
        out.append(tok)
    return out


# ---------------------------------------------------------------------------
# rwkv6
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "arbiter", "arbiter_residency"])
def test_rwkv_drain_matches_jax(mode):
    """Six requests of 3-9 prompt tokens in eight lanes, every request the
    first in its lane: tokens, full-depth exits, telemetry, lifecycle
    stamps and modeled energy equal to the JAX server's."""
    cfg = _models("rwkv6_7b")["cfg"]
    prompts = _prompts(cfg, (6, 5, 9, 3, 7, 4), seed=2)
    kw = dict(lanes=8, arbiter=mode != "plain", residency=mode == "arbiter_residency")
    js, ts = _drain("jax", "rwkv6_7b", prompts, **kw), _drain("torch", "rwkv6_7b", prompts, **kw)
    assert_same_servers(js, ts)
    st = ts.telemetry()
    assert st["completed"] == len(prompts) and st["tokens"] == 5 * len(prompts)
    assert st["decode_traces"] == 1 and st["prefill_traces"] == 1
    assert st["avg_token_exit_layer"] == cfg.n_layers
    if mode != "plain":
        assert st["accepted_slo_misses"] == 0 and all(r.energy_j > 0 for r in ts.done.values())
    if mode == "arbiter_residency":
        assert ts.residency.telemetry()["task_swaps"] == 1


@pytest.mark.parametrize("lanes", [1, 3])
def test_rwkv_every_request_matches_the_jax_model(lanes):
    """Seven requests through 1 or 3 lanes (refills into lanes that served
    another request): each request's tokens equal the JAX model's fresh
    init_cache -> prefill -> decode_step."""
    cfg = _models("rwkv6_7b")["cfg"]
    prompts = _prompts(cfg, (6, 5, 9, 3, 7, 4, 8), seed=3)
    ts = _drain("torch", "rwkv6_7b", prompts, lanes=lanes)
    for i, p in enumerate(prompts):
        assert ts.done[i].generated == _greedy_jax_model("rwkv6_7b", p, 5), i


def test_refill_does_not_carry_the_lane_history():
    """One lane, request 0 served alone, and served after request 1 (smoke
    weights from key 0, six new tokens).  The JAX server starts request 0's
    prefill from the state request 1 left in the lane, so its tokens
    differ; the port zeroes the state at refill and gives the same tokens
    both ways, equal to the JAX server's request served alone."""
    cfg = _models("rwkv6_7b", seed=0)["cfg"]
    a, b = _prompts(cfg, (6, 7), seed=0)

    def served(pkg, order):
        srv = _drain(pkg, "rwkv6_7b", [], lanes=1, seed=0)
        Request = JRequest if pkg == "jax" else TRequest
        for uid in order:
            srv.submit(Request(uid=uid, tokens=(a, b)[uid], max_new_tokens=6))
        srv.run()
        assert [r.uid for r in sorted(srv.done.values(), key=lambda r: r.retire_step)] == list(order)
        return srv.done[0].generated

    j_alone, j_after = served("jax", (0,)), served("jax", (1, 0))
    t_alone, t_after = served("torch", (0,)), served("torch", (1, 0))
    assert j_alone != j_after
    assert t_alone == t_after == j_alone


def test_rwkv_preempted_request_resumes_exactly():
    """A preempted request's recurrent state round-trips through the
    checkpoint into whatever lane is free, and the preempting request
    starts from a zero state: every request's tokens equal its tokens
    served alone."""
    cfg = _models("rwkv6_7b")["cfg"]
    prompts = _prompts(cfg, (6, 5, 7), seed=4)
    model, params = _models("rwkv6_7b")["torch"]
    srv = TDecoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), preempt=True, device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(TRequest(uid=i, tokens=p, max_new_tokens=6))
    srv.step()
    srv.submit(TRequest(uid=99, tokens=prompts[0][:4], max_new_tokens=2, deadline_s=3.0))
    srv.run()
    assert srv.telemetry()["preemptions"] >= 1
    for uid, req in srv.done.items():
        alone = _drain("torch", "rwkv6_7b", [req.tokens], lanes=1, new=req.max_new_tokens).done[0]
        assert req.generated == alone.generated, uid


def test_rwkv_server_refuses_exit_and_spec():
    model, params = _models("rwkv6_7b")["torch"]
    for kw in ({"exit_threshold": 1.0}, {"exit_threshold": 1.0, "spec_window": 2}, {"spec_window": 2}):
        with pytest.raises(ValueError, match="ssm"):
            TDecoder(model, params, device="cpu", **kw)


# ---------------------------------------------------------------------------
# minitron-8b (the LayerNorm decoder, GQA 8 / 2 at smoke size)
# ---------------------------------------------------------------------------


def _threshold(q=0.8):
    jm, jp = _models("minitron_8b")["jax"]
    return j_probe(jm, jp, _prompts(_models("minitron_8b")["cfg"], (6, 5, 7, 4, 6)), max_new_tokens=4, quantile=q)


@pytest.mark.parametrize("W", [1, 4])
def test_minitron_drain_matches_jax(W):
    """Nine requests through 4 lanes (refills into the KV cache), per-token
    exit at the probe's 0.8 quantile and an arbiter, spec window 1 or 4."""
    cfg = _models("minitron_8b")["cfg"]
    thr = _threshold()
    prompts = _prompts(cfg, (6, 5, 7, 4, 9, 3, 6, 8, 5), seed=5)
    js = _drain("jax", "minitron_8b", prompts, lanes=4, W=W, thr=thr, arbiter=True)
    ts = _drain("torch", "minitron_8b", prompts, lanes=4, W=W, thr=thr, arbiter=True)
    assert_same_servers(js, ts)
    st = ts.telemetry()
    assert st["completed"] == len(prompts) and st["decode_traces"] == 1 and st["prefill_traces"] == 1
    assert st["accepted_slo_misses"] == 0
    assert {x for r in ts.done.values() for x in r.token_exit_layers} <= {1, 2}


def test_minitron_spec_window_four_equals_one_bitwise_in_the_port():
    cfg = _models("minitron_8b")["cfg"]
    thr = _threshold()
    prompts = _prompts(cfg, (6, 5, 7, 4, 9, 3, 6, 8, 5), seed=5)
    s1, s4 = (_drain("torch", "minitron_8b", prompts, lanes=4, W=W, thr=thr) for W in (1, 4))
    for i in s1.done:
        assert s4.done[i].generated == s1.done[i].generated
        assert s4.done[i].token_exit_layers == s1.done[i].token_exit_layers
        np.testing.assert_array_equal(s4.done[i].result, s1.done[i].result)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_serve_launcher_ssm_and_layernorm_branches():
    stats = serve.main(["--arch", "rwkv6_7b", "--smoke", "--device", "cpu", "--requests", "3",
                        "--max-new-tokens", "2"])
    assert stats["completed"] == 3 and stats["tokens"] == 6 and stats["avg_token_exit_layer"] == 2.0
    with pytest.raises(ValueError, match="ssm"):
        serve.main(["--arch", "rwkv6_7b", "--smoke", "--device", "cpu", "--threshold", "1.0"])
    stats = serve.main(["--arch", "minitron_8b", "--smoke", "--device", "cpu", "--requests", "3",
                        "--max-new-tokens", "2", "--threshold", "100.0"])
    assert stats["completed"] == 3 and stats["tokens"] == 6 and stats["avg_token_exit_layer"] == 1.0
