"""The decoder families' training forwards (``Model.apply_train``), port
against the JAX package: logits, the MoE router's aux loss, and gradients
of ``lm_loss + aux`` (``make_loss_fn``) against ``jax.grad``.

The smoke configs of deepseek-7b (dense), qwen2-moe-a2.7b (MoE),
minitron-8b (the LayerNorm decoder), rwkv6-7b (ssm), zamba2-1.2b (hybrid,
in both of the JAX package's forms: the scan with a ``cond`` per block and
``hybrid_grouped``), whisper-medium (encdec) and llama-3.2-vision (vlm) in
float32; the JAX package initialises the params (the vlm's cross-layer
gates then set nonzero in the numpy tree: at their init of zero every
cross layer is the identity, and the image would never reach the logits),
the weight bridge carries them across, and the tokens, frames and image
embeddings are made by numpy from a seed.

Tolerances: logits atol 1e-5 (magnitudes below 1); the aux loss atol 1e-6;
losses 1e-6 relative; every gradient leaf within 1e-4 of that leaf's
largest magnitude (the SSD's and WKV's states reach ~20-30, and a leaf's
small entries carry its large ones' rounding); three AdamW steps (eps
1e-3, see the test): losses 1e-5 relative and params atol 1e-5; the port's
prefill and decode step against its own forward atol 1e-4.  zamba2 is held against JAX at
``ssm_chunk`` 2, where the JAX package's gradients are finite: at the smoke
chunk of 32 its chunked SSD exponentiates the decay's upper triangle before
masking it, the ``exp`` overflows, and the backward multiplies that inf by
a zero cotangent (NaN); the port masks the exponent first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro.training.optim import AdamWConfig as JAdamWConfig
from repro.training.optim import adamw_init as j_adamw_init
from repro.training.train_loop import make_loss_fn as j_loss_fn
from repro.training.train_loop import make_train_step as j_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.launch import train as t_train_launch
from repro_torch.models import mamba2 as TM
from repro_torch.models.model import build_model as t_build
from repro_torch.training.optim import AdamWConfig, adamw_init
from repro_torch.training.train_loop import make_loss_fn, make_train_step, value_and_grad

LOGIT_ATOL = 1e-5
GRAD_REL = 1e-4
GATES = {"gate_attn": (0.7, -0.5), "gate_mlp": (0.4, 0.9)}

# (arch, config overrides): every decoder family, zamba2 in both forms
CASES = [
    ("deepseek_7b", {}),
    ("qwen2_moe_a2p7b", {}),
    ("minitron_8b", {}),
    ("rwkv6_7b", {}),
    ("zamba2_1p2b", {}),
    ("zamba2_1p2b", {"hybrid_grouped": True}),
    ("whisper_medium", {}),
    ("llama3_2_vision_90b", {}),
]
IDS = [a + ("_grouped" if kw else "") for a, kw in CASES]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_CACHE = {}


def _setup(arch, **kw):
    """(JAX model, port model, JAX params, port params, config): one JAX
    draw per (arch, overrides), the vlm's gates set nonzero."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, tcfg = (dataclasses.replace(get(arch), dtype="float32", remat_policy="none", **kw)
                      for get in (j_smoke, t_smoke))
        jm = j_build(jcfg)
        jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
        if "cross_layers" in jp:
            for name, vals in GATES.items():
                jp["cross_layers"][name] = np.asarray(vals, np.float32)
        tp = params_from_numpy(jp, device="cpu")
        _CACHE[key] = (jm, t_build(tcfg), jax.tree_util.tree_map(jnp.asarray, jp), tp, tcfg)
    return _CACHE[key]


def _batch(cfg, B=2, S=12, seed=0):
    """numpy tokens, with the frames or image embeddings (x 0.1, as the JAX
    tests scale theirs) the family's forward takes."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "encdec":
        batch["enc_input"] = (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grads_both(jm, tm, jp, tp, batch):
    """((JAX loss, grads by keystr), (port loss, grads by keystr))."""
    (lj, _), gj = jax.value_and_grad(j_loss_fn(jm), has_aux=True)(jp, _j(batch))
    tloss = make_loss_fn(tm)
    tb = _t(batch)
    (lt, _), gt = value_and_grad(lambda p: tloss(p, tb), tp)
    gj = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(gj)}
    return (float(lj), gj), (float(lt), {k: v.numpy() for k, v in tree_leaves_with_path(gt)})


def _assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.isfinite(w).all() and np.isfinite(got[k]).all(), k
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_REL * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# the forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_apply_train_matches_jax(arch, kw):
    """Logits [B, S, V] and the aux loss (the MoE router's, summed over the
    layers; zero for the other families) equal the JAX forward's."""
    jm, tm, jp, tp, cfg = _setup(arch, **kw)
    batch = _batch(cfg)
    jo = jm.apply_train(jp, _j(batch))
    to = tm.apply_train(tp, batch)
    assert to.logits.shape == (2, 12, cfg.vocab_size)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=LOGIT_ATOL, rtol=0)
    assert to.aux_loss.dtype == torch.float32 and to.aux_loss.shape == ()
    np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss), atol=1e-6, rtol=0)
    if cfg.family == "moe":
        assert float(to.aux_loss) > 0.5 * cfg.n_layers     # E * sum(me * ce) per layer, ~1 each
    else:
        assert float(to.aux_loss) == 0.0


def test_moe_forward_routes_as_the_config_groups():
    """``moe_grouped_dispatch`` routes each batch row on its own (the aux
    loss then the mean over rows), as the JAX package's ``vmap`` does; the
    flat routing takes all B x S tokens together.  Both equal JAX's."""
    for grouped in (False, True):
        jm, tm, jp, tp, cfg = _setup("qwen2_moe_a2p7b", moe_grouped_dispatch=grouped)
        batch = _batch(cfg, B=3, S=10, seed=4)
        jo, to = jm.apply_train(jp, _j(batch)), tm.apply_train(tp, batch)
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits), atol=LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(float(to.aux_loss), float(jo.aux_loss), atol=1e-6, rtol=0)


def test_the_vlm_image_and_the_encdec_frames_reach_the_logits():
    """Another image or other frames change the training logits (the vlm's
    gates are nonzero here); the forward refuses a batch without them."""
    for arch in ("llama3_2_vision_90b", "whisper_medium"):
        _, tm, _, tp, cfg = _setup(arch)
        a, b = _batch(cfg, seed=1), _batch(cfg, seed=2)
        b["tokens"] = a["tokens"]
        la, lb = tm.apply_train(tp, a).logits, tm.apply_train(tp, b).logits
        assert (la - lb).abs().max() > 1e-3, arch
        key = "image_embeds" if cfg.family == "vlm" else "enc_input"
        with pytest.raises(ValueError, match=key):
            tm.apply_train(tp, {"tokens": a["tokens"]})


def test_vlm_zero_gates_make_the_image_invisible():
    """At the JAX init's zero gates every cross layer is the identity in
    both packages: another image leaves the logits unchanged, which is why
    every vlm test here sets the gates nonzero first."""
    jcfg, tcfg = (dataclasses.replace(get("llama3_2_vision_90b"), dtype="float32") for get in (j_smoke, t_smoke))
    jm, tm = j_build(jcfg), t_build(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    a, b = _batch(tcfg, seed=1), _batch(tcfg, seed=2)
    b["tokens"] = a["tokens"]
    assert torch.equal(tm.apply_train(tp, a).logits, tm.apply_train(tp, b).logits)
    np.testing.assert_array_equal(np.asarray(jm.apply_train(jp, _j(a)).logits),
                                  np.asarray(jm.apply_train(jp, _j(b)).logits))


# ---------------------------------------------------------------------------
# the gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_gradients_match_jax(arch, kw):
    """``make_loss_fn``'s lm_loss + aux and its gradient with respect to
    every leaf against ``jax.value_and_grad`` of the JAX package's; zamba2
    at ``ssm_chunk`` 2 (see the module docstring)."""
    if arch == "zamba2_1p2b":
        kw = dict(kw, ssm_chunk=2)
    jm, tm, jp, tp, cfg = _setup(arch, **kw)
    (lj, gj), (lt, gt) = _grads_both(jm, tm, jp, tp, _batch(cfg, seed=5))
    assert abs(lt - lj) <= 1e-6 * abs(lj)
    _assert_grads_close(gt, gj)
    if cfg.family == "vlm":
        # the gates get a gradient: the cross layers are on the path
        assert all(np.abs(gt[f"['cross_layers']['{g}']"]).min() > 0 for g in GATES)


def test_zamba2_chunk32_gradients_finite_in_the_port_alone():
    """zamba2 smoke at its own ssm_chunk 32, batch 2 x 64 tokens: the JAX
    package's gradients are NaN in most leaves (the decay's overflowing
    exp times a zero cotangent), the port's are finite and equal its
    gradients at chunk 2 within GRAD_REL of each leaf's magnitude, and
    its loss equals JAX's (the forward is the same)."""
    batch = _batch(_setup("zamba2_1p2b")[4], S=64, seed=6)
    jm, tm, jp, tp, cfg = _setup("zamba2_1p2b")
    assert cfg.ssm_chunk == 32
    (lj, gj), (lt, gt) = _grads_both(jm, tm, jp, tp, batch)
    assert abs(lt - lj) <= 1e-6 * abs(lj)
    nonfinite = [k for k, g in gj.items() if not np.isfinite(g).all()]
    assert len(nonfinite) >= len(gj) // 2 and "['embed']['tok']" in nonfinite
    assert all(np.isfinite(g).all() for g in gt.values())
    _, tm2, _, tp2, _ = _setup("zamba2_1p2b", ssm_chunk=2)
    tloss = make_loss_fn(tm2)
    tb = _t(batch)
    (lt2, _), gt2 = value_and_grad(lambda p: tloss(p, tb), tp2)
    assert abs(float(lt2) - lt) <= 1e-6 * abs(lt)
    _assert_grads_close(gt, {k: v.numpy() for k, v in tree_leaves_with_path(gt2)})


def test_ssd_exponent_mask_keeps_the_decay_bit_for_bit():
    """Masking the exponent before ``exp`` gives the decay the JAX order
    (``exp``, then ``where``) gives, bit for bit, overflowing entries of
    the upper triangle included: exp(-inf) is exactly the 0 the mask
    picks.  So every forward value of ``_ssd_chunked`` is unchanged (the
    ops after the decay are the same)."""
    g = torch.Generator().manual_seed(0)
    seg = torch.randn(2, 3, 32, 32, 4, generator=g) * 60.0        # |seg| up to ~250: exp overflows
    causal = torch.tril(torch.ones((32, 32), dtype=torch.bool))[None, None, :, :, None]
    old = torch.where(causal, torch.exp(seg), torch.zeros(()))
    new = torch.exp(torch.where(causal, seg, float("-inf")))
    assert torch.isinf(torch.exp(seg)[~causal.expand_as(seg)]).any()
    assert torch.equal(old, new)
    # and the function's output against JAX's at dt large enough to overflow
    # (outputs and states reach ~35: within 1e-5 of the leaf's magnitude)
    from repro.models import mamba2 as JM

    rng = np.random.default_rng(7)
    B, S, H, P, N = 2, 40, 3, 4, 5
    x, Bm, Cm = (rng.standard_normal(s).astype(np.float32) for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    dt = (rng.random((B, S, H)) * 5.0).astype(np.float32)
    a = -np.array([1.0, 8.0, 16.0], np.float32)
    yj, sj = JM._ssd_chunked(*(jnp.asarray(v) for v in (x, dt, a, Bm, Cm)), 32)
    yt, st = TM._ssd_chunked(*(torch.as_tensor(v) for v in (x, dt, a, Bm, Cm)), 32)
    for got, want in ((yt, yj), (st, sj)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# decode against the forward, and training steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_prefill_and_decode_match_the_forward(arch, kw):
    """The port's own ``init_cache`` -> ``prefill(prompt)`` ->
    ``decode_step(token)`` against its training forward at the same
    positions (``tests/test_models.py::test_decode_consistency`` on the
    port, for every decoder family): atol 1e-4 (float32 sums of another
    shape: the chunked WKV and SSD against their one-token steps, a batched
    prefill against one-row steps).  Each MoE call routes another group of
    tokens, and capacity couples a group's tokens, so the MoE family runs
    one row of 4 tokens: capacity is 4 slots an expert in every call, and
    each token takes an expert at most once, so no assignment is dropped
    anywhere (at 2 x 24 tokens the forward drops some, and the prefill's
    logits move by 2.3e-2, the decode step's by 0.6)."""
    _, tm, _, tp, cfg = _setup(arch, **kw)
    B, S = (1, 4) if cfg.family == "moe" else (2, 24)
    batch = _batch(cfg, B, S, seed=2)
    full = tm.apply_train(tp, batch).logits
    aux = {k: torch.as_tensor(v) for k, v in batch.items() if k != "tokens"} or None
    toks = torch.as_tensor(batch["tokens"])
    with torch.no_grad():
        lg_p, cache = tm.prefill(tp, toks[:, :S - 1], tm.init_cache(B, 64, device="cpu"), aux=aux)
        lg_d, cache = tm.decode_step(tp, cache, toks[:, S - 1:], S - 1)
    np.testing.assert_allclose(lg_p[:, 0].numpy(), full[:, S - 2].detach().numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lg_d[:, 0].numpy(), full[:, S - 1].detach().numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", ["deepseek_7b", "rwkv6_7b", "zamba2_1p2b"])
def test_three_train_steps_match_jax(arch):
    """Three ``make_train_step`` AdamW steps from the same params and data:
    every step's loss within 1e-5 relative and every param after the third
    within atol 1e-5 of the JAX package's (zamba2 at ssm_chunk 2).  Adam's
    eps is 1e-3 here: at its default of 1e-8 the first update is
    sign(g) * lr, so a gradient entry within rounding of zero moves its
    param by +-lr in either package (rwkv6 smoke: params 1.6e-3 apart after
    one step, 1.6 lr), and the steps after it part; the gradients
    themselves are held leaf by leaf in ``test_gradients_match_jax``."""
    kw = {"ssm_chunk": 2} if arch == "zamba2_1p2b" else {}
    jm, tm, jp, tp, cfg = _setup(arch, **kw)
    opt = dict(lr=1e-3, eps=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(j_train_step(jm, JAdamWConfig(**opt)))
    tstep = make_train_step(tm, AdamWConfig(**opt))
    jps, jos = jp, j_adamw_init(jp)
    tps, tos = tp, adamw_init(tp)
    for step in range(3):
        batch = _batch(cfg, B=2, S=16, seed=10 + step)
        jps, jos, jm_ = jstep(jps, jos, _j(batch))
        tps, tos, tm_ = tstep(tps, tos, _t(batch))
        assert abs(float(tm_["loss"]) - float(jm_["loss"])) <= 1e-5 * abs(float(jm_["loss"])), step
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(jps)}
    for k, v in tree_leaves_with_path(tps):
        np.testing.assert_allclose(v.numpy(), want[k], atol=1e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("arch", ["deepseek_7b", "qwen2_moe_a2p7b", "rwkv6_7b", "zamba2_1p2b"])
def test_train_launcher_trains_the_decoders(arch, tmp_path):
    """``launch/train.py --arch <decoder> --smoke --device cpu`` takes the
    generic route on SyntheticLM tokens: finite losses, a checkpoint."""
    out = t_train_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
                               "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert out["route"] == "generic" and np.isfinite(out["final"]["loss"])
    assert (tmp_path / "step_00000002").is_dir()


@pytest.mark.parametrize("arch", ["whisper_medium", "llama3_2_vision_90b"])
def test_train_launcher_says_what_encdec_and_vlm_lack(arch, tmp_path):
    """SyntheticLM makes tokens alone, so the encdec and vlm forwards would
    miss their frames or image: the launcher exits naming the input."""
    key = "enc_input" if arch == "whisper_medium" else "image_embeds"
    with pytest.raises(SystemExit, match=key):
        t_train_launch.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                             "--ckpt-dir", str(tmp_path)])
