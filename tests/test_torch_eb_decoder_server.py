"""EdgeBERT's features on every decoder family through the DecoderServer,
port against the JAX server, and the serving prefill's shared AF bias
(ROADMAP Queue 3 item 13).

The configs, params and tolerances of ``test_torch_eb_decoders.py``
(AF(8,3) activations and spans on, span_z from a seed in [0, 8], the
vlm's gates nonzero, float32): served tokens and exit depths equal, final
logits atol 1e-5, the bucket's cache at the end of the drain (every lane's
KV rows or recurrent state) within 1e-5 of each leaf's largest magnitude.
The prompts' seeds were checked to put no activation on an AF rounding
boundary in either package (a flip would part the logits by a quantum and
fail the tolerance at once).  Per-token exit and spec windows on the dense,
MoE and LayerNorm dense decoders, plain decode on the rest; the recurrent
families (rwkv6, zamba2) only where every request is the first in its lane
(lanes >= requests: ROADMAP Port rules, Recurrent state).

Item 13: the JAX server's prefill steps every lane in one batched
``decode_step`` (token 0 on the other lanes), not ``vmap``ped, so the
activation quantization takes one AF bias over all of them: a prompt
prefilled in lane 1 of 3 writes other KV rows than the same prompt in a
one-lane cache.  The port serves as the JAX server serves: its
``decoder_prefill`` reproduces the shared bias (the lane and one dummy row
for the dense, MoE, encdec and vlm families, whose dummy lanes are
identical; every lane's live row for the ssm and hybrid families, across
replicas too).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import step_math as jstep
from repro.serving.engine import DecoderServer as JDecoder
from repro.serving.engine import Request as JRequest
from repro.serving.engine import probe_exit_threshold as j_probe
from repro_torch.serving import step_math as tstep
from repro_torch.serving.engine import DecoderServer as TDecoder
from repro_torch.serving.engine import Request as TRequest
from tests.test_torch_eb_decoders import ARCHS, EXIT_ARCHS, setup
from tests.test_torch_ssm_server import _prompts

ATOL = 1e-5
REL = 1e-5
RECURRENT = ("rwkv6_7b", "zamba2_1p2b")
# the drains' prompt seed by (arch, lanes, W), default 2: with one intra-op
# thread, seed 2 puts an activation on an AF rounding boundary (the packages'
# float32 sums differ by an ulp there, the quantized values by a quantum,
# which the KV rows or the recurrent state then carry) in these cells and
# none of the seeds below does.  rwkv6's one-token decode differs from the
# JAX package's by ~5e-5 of its state's magnitude before any quantization
# (the recurrent step scales rounding: ROADMAP Queue 3 item 10), so its
# activations meet boundaries more often than the KV-cache families'.
PROMPT_SEED = {("deepseek_7b", 3, 1): 3, ("deepseek_7b", 3, 4): 3, ("minitron_8b", 3, 4): 3,
               ("rwkv6_7b", 1, 1): 4, ("llama3_2_vision_90b", 1, 1): 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _final_cache(srv, pkg):
    """Wrap the server's ``bucket_end`` to keep the bucket's cache (every
    lane's rows) as numpy before the server drops it."""
    kept = {}
    real = srv.bucket_end

    def bucket_end(bucket):
        c = srv._bstate[bucket]["cache"]
        if pkg == "jax":
            kept[bucket] = {k: np.asarray(v) for k, v in c.items()}
        else:
            kept[bucket] = {k: torch.cat([r[k] for r in c], dim=1).numpy() for k in c[0]}
        real(bucket)

    srv.bucket_end = bucket_end
    return kept


def _drain(pkg, arch, prompts, *, lanes, W=1, thr=None, new=4, **kw):
    jm, tm, jp, tp, cfg = setup(arch)
    model, params = (jm, jp) if pkg == "jax" else (tm, tp)
    Decoder, Request = (JDecoder, JRequest) if pkg == "jax" else (TDecoder, TRequest)
    kw.update({"use_pallas": True} if pkg == "jax" else {"device": "cpu"})
    if W > 1:
        kw.update(spec_window=W)
    srv = Decoder(model, params, batch_lanes=lanes, max_seq=32, eos_id=-1, buckets=(16,), exit_threshold=thr, **kw)
    kept = _final_cache(srv, pkg)
    for i, p in enumerate(prompts):
        srv.submit(Request(uid=i, tokens=p, max_new_tokens=new))
    srv.run()
    return srv, kept


def _threshold(arch, prompts):
    jm, _, jp, _, _ = setup(arch)
    return j_probe(jm, jp, prompts, max_new_tokens=3, quantile=0.5)


def _assert_same(js, ts, jk, tk):
    assert sorted(js.done) == sorted(ts.done)
    for uid in js.done:
        a, b = js.done[uid], ts.done[uid]
        assert a.generated == b.generated, uid
        assert a.token_exit_layers == b.token_exit_layers, uid
        if a.result is not None:
            np.testing.assert_allclose(b.result, np.asarray(a.result), atol=ATOL, rtol=0)
    assert sorted(jk) == sorted(tk)
    for bucket in jk:
        for k, want in jk[bucket].items():
            scale = max(float(np.abs(want.astype(np.float32)).max()), 1e-30)
            err = float(np.abs(tk[bucket][k].astype(np.float32) - want.astype(np.float32)).max())
            assert err <= REL * scale, (bucket, k, err, scale)


SERVED = ([(a, lanes, W) for a in EXIT_ARCHS for lanes in (1, 3) for W in (1, 4)]
          + [(a, lanes, 1) for a in ARCHS if a not in EXIT_ARCHS for lanes in (1, 3)])


@pytest.mark.parametrize("arch,lanes,W", SERVED, ids=[f"{a}-lanes{n}-W{w}" for a, n, w in SERVED])
def test_drain_matches_the_jax_server(arch, lanes, W):
    """Prompts of 5, 7, 4 and 6 tokens (refills at 1 and 3 lanes) through
    both servers; the dense, MoE and LayerNorm dense decoders with
    per-token exit at the JAX probe's median first entropy, at spec window
    W; the recurrent families with as many requests as lanes."""
    cfg = setup(arch)[4]
    n_req = lanes if arch in RECURRENT else 4
    prompts = _prompts(cfg, (5, 7, 4, 6)[:n_req], seed=PROMPT_SEED.get((arch, lanes, W), 2))
    thr = _threshold(arch, prompts) if arch in EXIT_ARCHS else None
    (js, jk), (ts, tk) = (_drain(pkg, arch, prompts, lanes=lanes, W=W, thr=thr) for pkg in ("jax", "torch"))
    _assert_same(js, ts, jk, tk)
    st = ts.telemetry()
    assert st["completed"] == n_req and st["decode_traces"] == 1 and st["prefill_traces"] == 1
    if thr is not None:
        depths = {x for r in ts.done.values() for x in r.token_exit_layers}
        assert 1 in depths or len(depths) > 1


@pytest.mark.parametrize("arch", EXIT_ARCHS)
def test_spec_window_four_equals_one_bitwise_in_the_port(arch):
    """Each spec slot is one batched ``decode_step_ee`` with one AF bias
    per lane, so W = 4 gives W = 1's tokens, exits and logits bit for
    bit."""
    cfg = setup(arch)[4]
    prompts = _prompts(cfg, (5, 7, 4, 6, 3), seed=4)
    thr = _threshold(arch, prompts)
    s1, s4 = (_drain("torch", arch, prompts, lanes=3, W=W, thr=thr)[0] for W in (1, 4))
    for i in s1.done:
        assert s4.done[i].generated == s1.done[i].generated
        assert s4.done[i].token_exit_layers == s1.done[i].token_exit_layers
        np.testing.assert_array_equal(s4.done[i].result, s1.done[i].result)


# ---------------------------------------------------------------------------
# item 13: the serving prefill's shared AF bias
# ---------------------------------------------------------------------------


def _live_cache(arch, lanes, seed=5):
    """Both packages' bucket caches with every leaf filled from a seed
    (the other lanes' live rows: KV rows, or the recurrent state a lane
    carries mid-request), the same numbers in each."""
    jm, tm, _, _, _ = setup(arch)
    rng = np.random.default_rng(seed)
    jc = jm.init_cache(lanes, 16)
    filled = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.asarray(v).dtype) for k, v in jc.items()}
    return ({k: jnp.asarray(v) for k, v in filled.items()},
            {k: torch.as_tensor(v.copy()) for k, v in filled.items()})


def _jax_prefill(arch, cache, prompt, lane, lanes):
    jm, _, jp, _, _ = setup(arch)
    toks = np.zeros(16, np.int32)
    toks[:len(prompt)] = prompt
    return jstep.decoder_prefill(jm, jp, cache, jnp.asarray(toks), lane, len(prompt), lanes, use_pallas=True)


def _port_prefill(arch, cache, prompt, lane, **kw):
    _, tm, _, tp, _ = setup(arch)
    toks = np.zeros(16, np.int64)
    toks[:len(prompt)] = prompt
    with torch.no_grad():
        return tstep.decoder_prefill(tm, tp, cache, toks, lane, len(prompt), use_kernels=True, **kw)


def _rows_close(t_rows, j_rows, rel=REL):
    for k, want in j_rows.items():
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(np.asarray(t_rows[k], np.float32) - want).max())
        assert err <= rel * scale, (k, err, scale)


def test_jax_prefill_couples_the_lanes_and_the_port_serves_as_it_does():
    """Both sides of item 13 on deepseek-7b: in the JAX package a prompt
    prefilled into lane 1 of 3 writes KV rows that differ from the same
    prompt in a one-lane cache by more than 1e-3 with quantization on (the
    bias over all lanes) and by less than 1e-4 with it off; the port's
    prefill at 3 lanes gives the JAX package's 3-lane rows within 1e-5 of
    their magnitude."""
    arch = "deepseek_7b"
    cfg = setup(arch)[4]
    prompt = _prompts(cfg, (12,), seed=7)[0]
    diffs = {}
    for quant in (True, False):
        jm, _, jp, _, _ = setup(arch)
        model = jm if quant else type(jm)(jm.cfg.with_edgebert(
            quant=dataclasses.replace(jm.cfg.edgebert.quant, enabled=False)))
        toks = np.zeros(16, np.int32)
        toks[:len(prompt)] = prompt
        three = jstep.decoder_prefill(model, jp, model.init_cache(3, 16), jnp.asarray(toks), 1, len(prompt), 3,
                                      use_pallas=True)
        one = jstep.decoder_prefill(model, jp, model.init_cache(1, 16), jnp.asarray(toks), 0, len(prompt), 1,
                                    use_pallas=True)
        diffs[quant] = max(float(np.abs(np.asarray(three[k])[:, 1, :len(prompt) - 1]
                                        - np.asarray(one[k])[:, 0, :len(prompt) - 1]).max()) for k in ("k", "v"))
        if quant:
            jc3 = three
    assert diffs[True] > 1e-3 and diffs[False] < 1e-4, diffs
    _, tm, _, _, _ = setup(arch)
    tc = _port_prefill(arch, tm.init_cache(3, 16, device="cpu"), prompt, 1)
    _rows_close({k: v[:, 1].numpy() for k, v in tc.items()}, {k: np.asarray(v)[:, 1] for k, v in jc3.items()})


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_prefill_matches_the_jax_prefill(arch, lanes):
    """The port's ``decoder_prefill`` of a 9-token prompt into the last lane
    against the JAX server's prefill at 1, 2 and 4 lanes, the other lanes
    holding live rows: the lane's rows (KV, or recurrent state) within 1e-5
    of their magnitude and the other lanes' rows untouched.  This is what
    lets the dense, MoE, encdec and vlm prefill step the lane and one zero
    dummy row: every dummy lane of the JAX call computes the same row."""
    cfg = setup(arch)[4]
    prompt = _prompts(cfg, (9,), seed=8)[0]
    jc, tc = _live_cache(arch, lanes)
    before = {k: v.clone() for k, v in tc.items()}
    lane = lanes - 1
    if arch in RECURRENT:
        # the port's server zeroes a refilled lane's recurrent state first:
        # start both packages' lane from zeros
        for k in tc:
            tc[k][:, lane].zero_()
        jc = {k: v.at[:, lane].set(0) for k, v in jc.items()}
    want = _jax_prefill(arch, jc, prompt, lane, lanes)
    got = _port_prefill(arch, tc, prompt, lane)
    _rows_close({k: v[:, lane].numpy() for k, v in got.items()}, {k: np.asarray(v)[:, lane] for k, v in want.items()})
    for k in got:
        assert torch.equal(got[k][:, :lane], before[k][:, :lane])


@pytest.mark.parametrize("arch", ["deepseek_7b", "qwen2_moe_a2p7b", "rwkv6_7b", "zamba2_1p2b"])
def test_sharded_prefill_matches_the_fleet_prefill(arch):
    """A replica's prefill (2 replicas x 2 lanes, the lane in replica 1)
    against the JAX package's prefill over the fleet's 4 lanes, as its
    sharded server runs it: ``group`` gives the fleet's lanes and the
    lane's index, ``fleet`` every replica's cache (the ssm and hybrid
    families' dummy lanes step their own live rows, copied from the other
    replica)."""
    cfg = setup(arch)[4]
    prompt = _prompts(cfg, (9,), seed=9)[0]
    jc, tc = _live_cache(arch, 4)
    lane = 2
    for k in tc:
        tc[k][:, lane].zero_()
    jc = {k: v.at[:, lane].set(0) for k, v in jc.items()}
    want = _jax_prefill(arch, jc, prompt, lane, 4)
    fleet = [{k: v[:, :2].clone() for k, v in tc.items()}, {k: v[:, 2:].clone() for k, v in tc.items()}]
    got = _port_prefill(arch, fleet[1], prompt, 0, group=(4, lane), fleet=fleet)
    _rows_close({k: v[:, 0].numpy() for k, v in got.items()}, {k: np.asarray(v)[:, lane] for k, v in want.items()})
    assert all(torch.equal(fleet[0][k], tc[k][:, :2]) for k in tc)
