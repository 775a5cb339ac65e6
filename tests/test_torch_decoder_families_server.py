"""The encoder-decoder (whisper) and vision decoder (llama-3.2-vision)
families through the DecoderServer, port against the JAX server.

The JAX server serves both in plain decode with no encoder or image input:
``Request`` has no field for one, the bucket's cache comes from
``init_cache`` (zero cross and image K/V), and its prefill runs
``decode_step`` alone, never ``prefill(aux=...)``.  The port serves them
the same way, so the served tokens are the JAX server's token for token,
and neither package's tokens depend on the cross layers' key and value
weights (``test_the_cross_kv_weights_do_not_reach_the_served_tokens``):
the queries meet zero keys, the softmax is uniform over zero values.
A request that needs its image or frames runs through the model's own
``prefill(aux=...)`` (``test_torch_vlm.py``, ``test_torch_encdec.py``).

The smoke configs in float32; the JAX package initialises the params (the
vlm's gates set nonzero, so its cross layers' MLPs change the tokens) and
the weight bridge carries them across.  The JAX servers run their Pallas
route in interpret mode (whisper's final LayerNorm of every decode step);
the port's run on the CPU, where the kernel route takes the plain
versions.  Neither family keeps recurrent state, so refilled lanes agree
with the JAX server too (lanes < requests).  Generated tokens, exit
depths, integers and flags equal; modeled floats (energies, clocks)
within rel 1e-9 (the ssm server tests' helpers).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro.serving import residency as jres
from repro.serving.engine import DecoderServer as JDecoder
from repro.serving.engine import Request as JRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import residency as tres
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest
from tests.test_torch_ssm_server import _arbiter, _prompts, assert_same_servers

ARCHS = ("whisper_medium", "llama3_2_vision_90b")
GATES = {"gate_attn": (0.7, -0.5), "gate_mlp": (0.4, 0.9)}
# the key and value weights of each family's cross layers
CROSS_KV = {"whisper_medium": "dec_cross", "llama3_2_vision_90b": "cross_layers"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_admission.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _models(arch, kv_scale=None):
    """{"jax": (model, params), "torch": (model, params), "cfg": cfg}: one
    JAX draw per arch (key 1), the vlm's gates set nonzero; with
    ``kv_scale`` every cross layer's wk and wv scaled by it and shifted by
    0.5."""
    key = (arch, kv_scale)
    if key not in _CACHE:
        jcfg, tcfg = (dataclasses.replace(get(arch), dtype="float32", remat_policy="none")
                      for get in (j_smoke, t_smoke))
        jm = j_build(jcfg)
        jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
        if "cross_layers" in jp:
            for name, vals in GATES.items():
                jp["cross_layers"][name] = np.asarray(vals, np.float32)
        if kv_scale is not None:
            xattn = jp[CROSS_KV[arch]]["xattn"]
            for w in ("wk", "wv"):
                xattn[w] = (xattn[w] * kv_scale + 0.5).astype(np.float32)
        _CACHE[key] = {"jax": (jm, jax.tree_util.tree_map(jax.numpy.asarray, jp)),
                       "torch": (t_build(tcfg), params_from_numpy(jp, device="cpu")), "cfg": tcfg}
    return _CACHE[key]


def _drain(pkg, arch, prompts, *, lanes, arbiter=False, residency=False, new=5, kv_scale=None, **kw):
    c = _models(arch, kv_scale)
    model, params = c[pkg]
    Decoder, Request, res = (JDecoder, JRequest, jres) if pkg == "jax" else (TDecoder, TRequest, tres)
    kw.update({"use_pallas": True} if pkg == "jax" else {"device": "cpu"})
    if residency:
        kw.update(task="lm", residency=res.TaskResidencyManager(
            [res.TaskDeployment("lm", n_params=2e5)], sram_bytes=1e9))
    srv = Decoder(model, params, batch_lanes=lanes, max_seq=32, eos_id=-1, buckets=(16,),
                  arbiter=_arbiter(pkg, c["cfg"].n_layers) if arbiter else None, **kw)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, tokens=p, max_new_tokens=new))
    srv.run()
    return srv


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["plain", "arbiter", "arbiter_residency"])
@pytest.mark.parametrize("lanes", [8, 3])
def test_drain_matches_the_jax_server(arch, mode, lanes):
    """Six requests of 3-9 prompt tokens in 8 lanes (each request first in
    its lane) or 3 (refills): tokens, full-depth exits, telemetry,
    lifecycle stamps and modeled energy equal to the JAX server's."""
    cfg = _models(arch)["cfg"]
    prompts = _prompts(cfg, (6, 5, 9, 3, 7, 4), seed=2)
    kw = dict(lanes=lanes, arbiter=mode != "plain", residency=mode == "arbiter_residency")
    js, ts = _drain("jax", arch, prompts, **kw), _drain("torch", arch, prompts, **kw)
    assert_same_servers(js, ts)
    st = ts.telemetry()
    assert st["completed"] == len(prompts) and st["tokens"] == 5 * len(prompts)
    assert st["decode_traces"] == 1 and st["prefill_traces"] == 1
    assert st["avg_token_exit_layer"] == cfg.n_layers
    if mode != "plain":
        assert st["accepted_slo_misses"] == 0 and all(r.energy_j > 0 for r in ts.done.values())
    if mode == "arbiter_residency":
        assert ts.residency.telemetry()["task_swaps"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_the_cross_kv_weights_do_not_reach_the_served_tokens(arch):
    """The reference's behaviour made explicit: with every cross layer's wk
    and wv scaled by 3 and shifted by 0.5, both servers give the same
    tokens as before, since neither ever writes the cache's cross or image
    K/V.  The model's own prefill over frames or an image does see them."""
    cfg = _models(arch)["cfg"]
    prompts = _prompts(cfg, (6, 5, 9), seed=3)
    for pkg in ("jax", "torch"):
        a = _drain(pkg, arch, prompts, lanes=4)
        b = _drain(pkg, arch, prompts, lanes=4, kv_scale=3.0)
        assert [a.done[i].generated for i in range(3)] == [b.done[i].generated for i in range(3)], pkg
    key = "enc_input" if cfg.family == "encdec" else "image_embeds"
    n_in = cfg.enc_seq_len if cfg.family == "encdec" else cfg.n_image_tokens
    aux = {key: torch.as_tensor(np.random.default_rng(4).standard_normal((1, n_in, cfg.d_model)) * 0.1,
                                dtype=torch.float32)}
    outs = []
    for scale in (None, 3.0):
        model, params = _models(arch, scale)["torch"]
        lg, _ = model.prefill(params, torch.as_tensor(prompts[0][None].astype(np.int64)),
                              model.init_cache(1, 16, device="cpu"), aux=aux)
        outs.append(lg)
    assert (outs[0] - outs[1]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_server_refuses_exit_and_spec(arch):
    model, params = _models(arch)["torch"]
    family = _models(arch)["cfg"].family
    for kw in ({"exit_threshold": 1.0}, {"exit_threshold": 1.0, "spec_window": 2}, {"spec_window": 2}):
        with pytest.raises(ValueError, match=f"{family} family has no per-token exit"):
            TDecoder(model, params, device="cpu", **kw)


def test_kernel_calls_on_the_served_paths():
    """On the kernel route whisper's final LayerNorm reaches
    ``dispatch.layernorm`` once per fused step and once per prefill token
    (the serving prefill is one-token ``decode_step``s), and nothing else
    is called; the vlm calls nothing (RMS norms, no exit).  The paths'
    kernel lists say the same."""
    assert ops.ENCDEC_DECODE_KERNELS == ("layernorm",) and ops.VLM_DECODE_KERNELS == ()
    for arch in ARCHS:
        cfg = _models(arch)["cfg"]
        prompts = _prompts(cfg, (6, 5, 7), seed=5)
        calls = []
        real = tdispatch.layernorm, tdispatch.entropy
        tdispatch.layernorm = lambda *a, **k: calls.append("layernorm") or real[0](*a, **k)
        tdispatch.entropy = lambda *a, **k: calls.append("entropy") or real[1](*a, **k)
        try:
            srv = _drain("torch", arch, prompts, lanes=2, new=4)
        finally:
            tdispatch.layernorm, tdispatch.entropy = real
        st = srv.telemetry()
        assert srv.use_kernels and st["completed"] == 3
        if cfg.family == "encdec":
            prefill_tokens = sum(len(p) - 1 for p in prompts)
            assert calls == ["layernorm"] * (st["decode_steps"] + prefill_tokens)
        else:
            assert calls == []


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_the_family(arch):
    stats = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3", "--max-new-tokens", "2"])
    cfg = _models(arch)["cfg"]
    assert stats["completed"] == 3 and stats["avg_token_exit_layer"] == cfg.n_layers
    assert 3 <= stats["tokens"] <= 6
    with pytest.raises(ValueError, match="no per-token exit"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--threshold", "1.0"])


@pytest.mark.parametrize("arch", ARCHS)
def test_preempted_request_resumes_exactly(arch):
    """A preempted request's K/V rows (cross and image rows with them)
    round-trip through the checkpoint into whatever lane is free: every
    request's tokens equal its tokens served alone."""
    cfg = _models(arch)["cfg"]
    prompts = _prompts(cfg, (6, 5, 7), seed=6)
    model, params = _models(arch)["torch"]
    srv = TDecoder(model, params, batch_lanes=2, max_seq=32, eos_id=-1, buckets=(16,), preempt=True, device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(TRequest(uid=i, tokens=p, max_new_tokens=6))
    srv.step()
    srv.submit(TRequest(uid=99, tokens=prompts[0][:4], max_new_tokens=2, deadline_s=3.0))
    srv.run()
    assert srv.telemetry()["preemptions"] >= 1
    for uid, req in srv.done.items():
        alone = _drain("torch", arch, [req.tokens], lanes=1, new=req.max_new_tokens).done[0]
        assert req.generated == alone.generated, uid
