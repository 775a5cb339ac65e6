"""The hybrid decoder (zamba2) through the DecoderServer, port against the
JAX package.

The smoke ``zamba2_1p2b`` config in float32; the JAX package initialises
the params and the weight bridge carries them across.  The JAX server runs
its Pallas route in interpret mode (no kernel is on this family's path in
either package: its norms are RMS, the shared block's cache attention
stays on the reference ops); the port's runs on the CPU.

At refill the port zeroes a lane's conv and SSM state (and the shared
block's K/V rows) before the new request's prefill; the JAX server carries
the state the lane's previous request left behind into it.  So the drains
are held against the JAX server where every request is the first in its
lane (lanes >= requests), and against the JAX model's own ``init_cache``
-> ``prefill`` -> ``decode_step`` for every request;
``test_refill_does_not_carry_the_lane_history`` shows the reference's
carry and the port's independence of it.

The drain helpers are the ssm family's (``test_torch_ssm_server.py``):
generated tokens, exit depths, integers and flags equal; modeled floats
(energies, clocks) within rel 1e-9.
"""
import numpy as np
import pytest
import torch

from repro.serving.engine import Request as JRequest
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest
from tests.test_torch_ssm_server import _drain, _greedy_jax_model, _models, _prompts, assert_same_servers

ARCH = "zamba2_1p2b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["plain", "arbiter", "arbiter_residency"])
def test_zamba2_drain_matches_jax(mode):
    """Six requests of 4-9 prompt tokens in eight lanes, every request the
    first in its lane: tokens, full-depth exits, telemetry, lifecycle
    stamps and modeled energy equal to the JAX server's."""
    cfg = _models(ARCH)["cfg"]
    prompts = _prompts(cfg, (6, 5, 9, 4, 7, 8), seed=2)
    kw = dict(lanes=8, arbiter=mode != "plain", residency=mode == "arbiter_residency")
    js, ts = _drain("jax", ARCH, prompts, **kw), _drain("torch", ARCH, prompts, **kw)
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
def test_zamba2_every_request_matches_the_jax_model(lanes):
    """Seven requests through 1 or 3 lanes (refills into lanes that served
    another request): each request's tokens equal the JAX model's fresh
    init_cache -> prefill -> decode_step."""
    cfg = _models(ARCH)["cfg"]
    prompts = _prompts(cfg, (6, 5, 9, 4, 7, 4, 8), seed=3)
    ts = _drain("torch", ARCH, prompts, lanes=lanes)
    for i, p in enumerate(prompts):
        assert ts.done[i].generated == _greedy_jax_model(ARCH, p, 5), i


def test_refill_does_not_carry_the_lane_history():
    """One lane, request 0 served alone, and served after request 1 (smoke
    weights from key 0, six new tokens).  The JAX server starts request 0's
    prefill from the conv and SSM state request 1 left in the lane, so its
    tokens differ; the port zeroes the lane at refill and gives the same
    tokens both ways, equal to the JAX server's request served alone."""
    cfg = _models(ARCH, seed=0)["cfg"]
    a, b = _prompts(cfg, (6, 7), seed=0)

    def served(pkg, order):
        srv = _drain(pkg, ARCH, [], lanes=1, seed=0)
        Request = TRequest if pkg == "torch" else JRequest
        for uid in order:
            srv.submit(Request(uid=uid, tokens=(a, b)[uid], max_new_tokens=6))
        srv.run()
        assert [r.uid for r in sorted(srv.done.values(), key=lambda r: r.retire_step)] == list(order)
        return srv.done[0].generated

    j_alone, j_after = served("jax", (0,)), served("jax", (1, 0))
    t_alone, t_after = served("torch", (0,)), served("torch", (1, 0))
    assert j_alone != j_after
    assert t_alone == t_after == j_alone


def test_zamba2_preempted_request_resumes_exactly():
    """A preempted request's conv, SSM state and K/V rows round-trip through
    the checkpoint into whatever lane is free, and the preempting request
    starts from a zero state: every request's tokens equal its tokens
    served alone."""
    cfg = _models(ARCH)["cfg"]
    prompts = _prompts(cfg, (6, 5, 7), seed=4)
    model, params = _models(ARCH)["torch"]
    srv = TDecoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), preempt=True, device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(TRequest(uid=i, tokens=p, max_new_tokens=6))
    srv.step()
    srv.submit(TRequest(uid=99, tokens=prompts[0][:4], max_new_tokens=2, deadline_s=3.0))
    srv.run()
    assert srv.telemetry()["preemptions"] >= 1
    for uid, req in srv.done.items():
        alone = _drain("torch", ARCH, [req.tokens], lanes=1, new=req.max_new_tokens).done[0]
        assert req.generated == alone.generated, uid


def test_no_kernel_on_the_hybrid_path():
    """A drain on the kernel route calls neither the layernorm nor the
    entropy dispatch: the family's norms are RMS, it has no exit."""
    cfg = _models(ARCH)["cfg"]
    calls = []
    real = tdispatch.layernorm, tdispatch.entropy
    tdispatch.layernorm = lambda *a, **k: calls.append("layernorm")
    tdispatch.entropy = lambda *a, **k: calls.append("entropy")
    try:
        srv = _drain("torch", ARCH, _prompts(cfg, (6, 5, 7), seed=5), lanes=2)
    finally:
        tdispatch.layernorm, tdispatch.entropy = real
    assert srv.use_kernels and srv.telemetry()["completed"] == 3 and calls == []


def test_zamba2_server_refuses_exit_and_spec():
    model, params = _models(ARCH)["torch"]
    for kw in ({"exit_threshold": 1.0}, {"exit_threshold": 1.0, "spec_window": 2}, {"spec_window": 2}):
        with pytest.raises(ValueError, match="hybrid family has no per-token exit"):
            TDecoder(model, params, device="cpu", **kw)


def test_serve_launcher_hybrid_branch():
    stats = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    cfg = _models(ARCH)["cfg"]
    assert stats["completed"] == 3 and stats["avg_token_exit_layer"] == cfg.n_layers
    assert 3 <= stats["tokens"] <= 6
    with pytest.raises(ValueError, match="hybrid"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--threshold", "1.0"])


def test_zamba2_prompt_lengths_the_server_takes():
    """The serving prefill steps one token at a time, so prompts of 1 and 2
    tokens (which ``Model.prefill`` refuses) are served, each as the port's
    model serves it from a fresh cache."""
    model, params = _models(ARCH)["torch"]
    prompts = [np.array([7], np.int32), np.array([7, 11], np.int32)]
    srv = _drain("torch", ARCH, prompts, lanes=2, new=3)
    for i, p in enumerate(prompts):
        cache = model.init_cache(1, 16, device="cpu")
        for t in range(len(p) - 1):
            model.decode_step(params, cache, torch.tensor([[int(p[t])]]), t)
        tok, out = int(p[-1]), []
        for t in range(3):
            lg, cache = model.decode_step(params, cache, torch.tensor([[tok]]), len(p) - 1 + t)
            tok = int(lg[0, -1].argmax())
            out.append(tok)
        assert srv.done[i].generated == out, i
