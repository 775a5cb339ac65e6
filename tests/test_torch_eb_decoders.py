"""EdgeBERT's features on every decoder family, port against the JAX
package: AdaptivFloat activation quantization after every layer, adaptive
spans (``span_z``), the off-ramp parameters and a classifier head.

The smoke configs of deepseek-7b (dense), qwen2-moe-a2.7b (MoE),
minitron-8b (the LayerNorm decoder), rwkv6-7b (ssm: quantization only, the
family is attention-free and has no ``span_z``), zamba2-1.2b (hybrid, at
``ssm_chunk`` 2, where the JAX package's gradients are finite: ROADMAP
Queue 3 item 11), whisper-medium (encdec) and llama-3.2-vision (vlm, its
cross-layer gates set nonzero) in float32, with ``QuantConfig(enabled=True)``
(AF(8,3) activations) and ``SpanConfig(enabled=True)``.  The JAX package
initialises the params and the weight bridge carries them across; span_z
is drawn by numpy from a seed in [0, 8] (at the init's 64 with a 32-token
ramp no head's mask would fall below 1 within these sequences), tokens,
frames and image embeddings too.

AF parity is bit-exact only where every binade lies in [-12, 12] (ROADMAP
Port rules, Numerics).  The quantized activations here (the training
forwards and prefills below) have amax between 2.3 and 7.9, the MoE
layers' 68 to 120, so the biases run from -6 to -1 and every binade used
lies in [-6, 6], well inside.  An AF rounding flip turns an ulp into a
quantum (2^(e - 4) in binade e: 0.002 to 0.06 at these magnitudes); the
seeds below were checked to put no element on a rounding boundary in
either package, which the tolerances would show at once, so every
comparison holds at float32 rounding:

* logits and decode outputs atol 1e-5 (magnitudes below 1; the MoE family's
  below 2);
* cache leaves within 1e-5 of each leaf's largest magnitude (the SSD's and
  WKV's states reach ~20-30);
* gradients within 1e-4 of each leaf's largest magnitude, ``span_z``'s
  included (as ``test_torch_train_forwards.py``);
* the classifier head's phase-1 losses 1e-4 relative, params atol 1e-4 (as
  ``test_torch_training.py``).

The AF bias follows the JAX package's grouping: per lane where its server
``vmap``s a one-lane call (the decode methods' ``per_lane``, held against
``repro.serving.step_math``'s vmapped steps), over the whole batch where it
makes the batched call (``per_lane=False``, ``prefill``, the training
forward).  ``dispatch.act_quantize`` (the quantize kernel) is reached
exactly where the JAX package passes ``use_pallas`` to ``_maybe_actquant``:
the dense and MoE decode methods and the serving prefill of those families,
nowhere else (``test_act_quantize_reached_where_the_jax_package_passes_use_pallas``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import QuantConfig as JQuant
from repro.configs.base import SpanConfig as JSpan
from repro.configs.base import get_smoke_config as j_smoke
from repro.data.synthetic import SyntheticCLS as JData
from repro.kernels import dispatch as jdispatch
from repro.models.model import build_model as j_build
from repro.serving import step_math as jstep
from repro.training import optim as joptim
from repro.training.train_loop import EdgeBertTrainer as JTrainer
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro.training.train_loop import make_loss_fn as j_loss_fn
from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.configs.base import QuantConfig as TQuant
from repro_torch.configs.base import SpanConfig as TSpan
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.data.synthetic import SyntheticCLS as TData
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params as t_init
from repro_torch.serving import step_math as tstep
from repro_torch.training import optim as toptim
from repro_torch.training.train_loop import EdgeBertTrainer as TTrainer
from repro_torch.training.train_loop import TrainerConfig as TTrainerConfig
from repro_torch.training.train_loop import make_loss_fn, value_and_grad

ATOL = 1e-5
REL = 1e-5
GRAD_REL = 1e-4
SPAN_MAX = 8.0
GATES = {"gate_attn": (0.7, -0.5), "gate_mlp": (0.4, 0.9)}
ARCHS = ("deepseek_7b", "qwen2_moe_a2p7b", "minitron_8b", "rwkv6_7b", "zamba2_1p2b", "whisper_medium",
         "llama3_2_vision_90b")
EXIT_ARCHS = ("deepseek_7b", "qwen2_moe_a2p7b", "minitron_8b")
# the training forward's batch seed per arch (default 0): at one intra-op
# thread, minitron-8b's seed-0 batch puts an element on an AF rounding
# boundary (logits part by 6.5e-4), as do deepseek-7b's seed 3, qwen2-moe's
# seed 1 and rwkv6-7b's seed 2; seed 1 puts none
TRAIN_SEED = {"minitron_8b": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eb_cfgs(arch, **kw):
    """(JAX config, port config): the smoke config in float32 with
    activation quantization and spans on (zamba2 at ssm_chunk 2)."""
    if arch == "zamba2_1p2b":
        kw.setdefault("ssm_chunk", 2)
    out = []
    for get, Q, S in ((j_smoke, JQuant, JSpan), (t_smoke, TQuant, TSpan)):
        c = dataclasses.replace(get(arch), dtype="float32", remat_policy="none", **kw)
        out.append(c.with_edgebert(quant=Q(enabled=True), span=S(enabled=True)))
    return out


_CACHE = {}


def setup(arch, span_seed=0, **kw):
    """(JAX model, port model, JAX params, port params, port config): one
    JAX draw per arch (key 1), span_z from ``span_seed`` in [0, SPAN_MAX],
    the vlm's gates nonzero."""
    key = (arch, span_seed, tuple(sorted(kw.items())))
    if key not in _CACHE:
        jcfg, tcfg = eb_cfgs(arch, **kw)
        jm = j_build(jcfg)
        jp = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(1)))
        if "span_z" in jp:
            jp["span_z"] = np.random.default_rng(span_seed).uniform(0, SPAN_MAX, jp["span_z"].shape).astype(np.float32)
        if "cross_layers" in jp:
            for name, vals in GATES.items():
                jp["cross_layers"][name] = np.asarray(vals, np.float32)
        _CACHE[key] = (jm, t_build(tcfg), jax.tree_util.tree_map(jnp.asarray, jp),
                       params_from_numpy(jp, device="cpu"), tcfg)
    return _CACHE[key]


def _batch(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "encdec":
        batch["enc_input"] = (rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)) * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = (rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def _aux(cfg, batch):
    """The prefill's aux (frames or image), for both packages."""
    key = {"encdec": "enc_input", "vlm": "image_embeds"}.get(cfg.family)
    return (None, None) if key is None else ({key: jnp.asarray(batch[key])}, {key: torch.as_tensor(batch[key])})


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def _close_cache(tc, jc):
    assert sorted(tc) == sorted(jc)
    for k, want in jc.items():
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(tc[k].numpy().astype(np.float32) - want).max())
        assert err <= REL * scale, (k, err, scale)


def _flat_grads(gj, gt):
    gj = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(gj)}
    return gj, {k: v.numpy() for k, v in tree_leaves_with_path(gt)}


# ---------------------------------------------------------------------------
# the params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_every_edgebert_leaf(arch):
    """With quantization, spans, early exit and a classifier head on, the
    port's ``init_params`` gives the JAX package's keys, shapes and dtypes
    (the classifier head, the float32 off-ramp, ``span_z`` [n_layers,
    n_heads] at init_span, none for the attention-free ssm family), and the
    bridge carries every leaf of the JAX tree across."""
    trees = []
    for (cfg, pkg) in zip(eb_cfgs(arch, num_classes=3), ("jax", "torch")):
        ex = dataclasses.replace(cfg.edgebert.early_exit, enabled=True)
        cfg = cfg.with_edgebert(early_exit=ex)
        if pkg == "jax":
            jp = jax.tree_util.tree_map(np.asarray, j_build(cfg).init_params(jax.random.PRNGKey(0)))
            trees.append({jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
                          for k, v in jax.tree_util.tree_leaves_with_path(jp)})
            bridged = params_from_numpy(jp, device="cpu")
        else:
            tp = t_init(cfg, torch.Generator().manual_seed(0), device="cpu")
            trees.append({k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree_leaves_with_path(tp)})
            assert {k for k, _ in tree_leaves_with_path(bridged)} == set(trees[1])
    want, got = trees
    assert got == want
    assert ("['span_z']" in got) == (arch != "rwkv6_7b")
    for k in ("['classifier']['cls_w']", "['offramp']['offramp_cls_w']"):
        assert k in got
    assert got["['offramp']['offramp_pooler_w']"][1] == "float32"
    if arch != "rwkv6_7b":
        cfg = eb_cfgs(arch)[1]
        z = t_init(cfg, device="cpu")["span_z"]
        assert z.shape == (cfg.n_layers, cfg.n_heads) and bool((z == cfg.edgebert.span.init_span).all())


# ---------------------------------------------------------------------------
# the training forwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_train_logits_and_gradients(arch):
    """``apply_train`` logits (atol 1e-5) and every gradient of ``lm_loss +
    aux + span loss`` within 1e-4 of its leaf's largest magnitude,
    ``span_z``'s included; quantization changes the logits (by more than
    1e-3) and, where there is a span, so does ``span_z``."""
    jm, tm, jp, tp, cfg = setup(arch)
    batch = _batch(cfg, seed=TRAIN_SEED.get(arch, 0))
    jo = jm.apply_train(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    to = tm.apply_train(tp, tb)
    _close(to.logits, jo.logits)
    _close(to.aux_loss, jo.aux_loss, atol=1e-6)
    plain = t_build(cfg.with_edgebert(quant=dataclasses.replace(cfg.edgebert.quant, enabled=False)))
    assert (plain.apply_train(tp, tb).logits - to.logits).abs().max() > 1e-3
    if "span_z" in tp:
        wide = dict(tp, span_z=torch.full_like(tp["span_z"], 64.0))
        assert (tm.apply_train(wide, tb).logits - to.logits).abs().max() > 1e-3
    (lj, _), gj = jax.value_and_grad(j_loss_fn(jm), has_aux=True)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    (lt, _), gt = value_and_grad(lambda p: make_loss_fn(tm)(p, tb), tp)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    gj, gt = _flat_grads(gj, gt)
    assert sorted(gt) == sorted(gj)
    for k, w in gj.items():
        assert np.isfinite(w).all() and np.isfinite(gt[k]).all(), k
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(gt[k] - w).max()) <= GRAD_REL * scale, (k, scale)
    if "span_z" in gt:
        assert np.abs(gt["['span_z']"]).max() > 0


def test_vlm_span_quirk():
    """The JAX package's vlm forward gives its self layers ``span_z[i]``
    only when span_z has a row per self layer (n_layers - n_layers /
    cross_attn_every), and ``span_z[:1]`` broadcast otherwise, which is
    every self layer under init_params' [n_layers, n_heads]: only row 0
    reaches the logits, the other rows get the span loss's gradient alone.
    The port repeats both forms."""
    jm, tm, jp, tp, cfg = setup("llama3_2_vision_90b")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    z = tp["span_z"]
    assert z.shape == (cfg.n_layers, cfg.n_heads)
    moved = dict(tp, span_z=torch.cat([z[:1], z[1:] + 3.0]))
    assert torch.equal(tm.apply_train(moved, tb).logits, tm.apply_train(tp, tb).logits)
    _, gt = value_and_grad(lambda p: (tm.apply_train(p, tb).logits.square().mean(), {}), tp)
    gz = gt["span_z"]
    assert gz[0].abs().max() > 0 and bool((gz[1:] == 0).all())
    # a row per self layer: each self layer its own row
    n_self = cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    z_self = np.random.default_rng(3).uniform(0, SPAN_MAX, (n_self, cfg.n_heads)).astype(np.float32)
    jo = jm.apply_train(dict(jp, span_z=jnp.asarray(z_self)), jb)
    to = tm.apply_train(dict(tp, span_z=torch.as_tensor(z_self)), tb)
    _close(to.logits, jo.logits)
    z_moved = z_self.copy()
    z_moved[1:] += 3.0
    assert (tm.apply_train(dict(tp, span_z=torch.as_tensor(z_moved)), tb).logits - to.logits).abs().max() > 1e-4


def test_dense_classifier_head_through_phase1():
    """A dense decoder with ``num_classes`` (deepseek-7b smoke, spans on,
    quantization off as every multi-step parity runs: an AF flip would
    carry into every later step) through ``EdgeBertTrainer.phase1`` on
    labelled SyntheticCLS batches: ``make_loss_fn`` takes
    ``edgebert_phase1_loss`` on ``cls_logits`` from the classifier head, in
    both packages.  Losses 1e-4 relative, params atol 1e-4."""
    cfgs = []
    for get, Q, S in ((j_smoke, JQuant, JSpan), (t_smoke, TQuant, TSpan)):
        c = dataclasses.replace(get("deepseek_7b"), dtype="float32", remat_policy="none", num_classes=3)
        cfgs.append(c.with_edgebert(span=S(enabled=True, ramp=16, loss_coef=0.05, init_span=8.0)))
    jcfg, tcfg = cfgs
    jp = j_build(jcfg).init_params(jax.random.PRNGKey(2))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    opt = dict(lr=2e-3, warmup_steps=2, total_steps=10, span_lr_mult=30.0)
    jtr = JTrainer(j_build(jcfg), JTrainerConfig(phase1_steps=4, phase2_steps=0, opt=joptim.AdamWConfig(**opt)))
    ttr = TTrainer(t_build(tcfg), TTrainerConfig(phase1_steps=4, phase2_steps=0, opt=toptim.AdamWConfig(**opt)))
    jout = jtr.phase1(jp, JData(jcfg.vocab_size, 16, 4, num_classes=3, seed=0), log_every=1000)
    tout = ttr.phase1(tp, TData(tcfg.vocab_size, 16, 4, num_classes=3, seed=0), log_every=1000)
    assert len(tout[2]) == len(jout[2]) == 4
    for t, j in zip(tout[2], jout[2]):
        for k in ("loss", "task_loss", "span_loss", "mean_span"):
            assert abs(t[k] - j[k]) <= 1e-4 * abs(j[k]), (k, t[k], j[k])
    got = {k: v.numpy() for k, v in tree_leaves_with_path(tout[0])}
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(jout[0])}
    assert sorted(got) == sorted(want) and "['classifier']['cls_w']" in got
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=1e-4, rtol=0, err_msg=k)
    out = t_build(tcfg).apply_train(tout[0], {"tokens": torch.zeros((2, 5), dtype=torch.int64)})
    assert out.cls_logits.shape == (2, 3) and out.cls_logits.dtype == torch.float32


# ---------------------------------------------------------------------------
# the decode methods
# ---------------------------------------------------------------------------


def _prefilled(arch, B=3, S=6, seed=1):
    """Both packages' caches after ``prefill`` of B prompts of S tokens
    (the JAX model's batched call: one AF bias over the batch), with the
    prefill's logits."""
    jm, tm, jp, tp, cfg = setup(arch)
    batch = _batch(cfg, B=B, S=S + 2, seed=seed)
    jaux, taux = _aux(cfg, batch)
    jl, jc = jm.prefill(jp, jnp.asarray(batch["tokens"][:, :S]), jm.init_cache(B, 16), aux=jaux)
    tl, tc = tm.prefill(tp, torch.as_tensor(batch["tokens"][:, :S]), tm.init_cache(B, 16, device="cpu"), aux=taux)
    return batch, (jl, jc), (tl, tc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step(arch):
    """``prefill`` then ``decode_step`` as one batch (``per_lane=False``,
    the JAX model's batched call) and per lane at per-lane positions (the
    JAX server's vmapped ``decoder_decode``): logits atol 1e-5, every cache
    leaf within 1e-5 of its magnitude."""
    jm, tm, jp, tp, cfg = setup(arch)
    B = 3
    batch, (jl, jc), (tl, tc) = _prefilled(arch, B=B)
    _close(tl, jl)
    _close_cache(tc, jc)
    tok = batch["tokens"][:, 6:7]
    # one batch, one position
    jl2, jc2 = jm.decode_step(jp, jc, jnp.asarray(tok), 6)
    tl2, tc2 = tm.decode_step(tp, {k: v.clone() for k, v in tc.items()}, torch.as_tensor(tok), 6, per_lane=False)
    _close(tl2, jl2)
    _close_cache(tc2, jc2)
    # per lane, each at its own position (the cache rows past a lane's
    # position are masked out of its attention)
    pos = np.array([6, 4, 5])
    jl3, jc3 = jstep.decoder_decode(jm, jp, jc, jnp.asarray(tok), jnp.asarray(pos))
    tl3, tc3 = tm.decode_step(tp, {k: v.clone() for k, v in tc.items()}, torch.as_tensor(tok), torch.as_tensor(pos))
    _close(tl3, jl3)
    _close_cache(tc3, jc3)


@pytest.mark.parametrize("arch", EXIT_ARCHS)
def test_decode_step_ee_and_spec(arch):
    """Per-token exit and speculative decode (dense, MoE, LayerNorm dense)
    against the JAX server's vmapped steps (one AF bias per lane, each
    layer's span): logits atol 1e-5, exit layers and accepted masks equal,
    first entropies atol 1e-5, every cache leaf within 1e-5 of its
    magnitude; the threshold exits some tokens early and keeps others."""
    jm, tm, jp, tp, cfg = setup(arch)
    batch, (_, jc), (_, tc) = _prefilled(arch, B=3)
    tok = batch["tokens"][:, 6:7]
    pos = np.array([6, 4, 5])
    probe = tm.decode_step_ee(tp, {k: v.clone() for k, v in tc.items()}, torch.as_tensor(tok), torch.as_tensor(pos),
                              1e9)[3]
    thr = float(np.median(probe.numpy()))
    jl, jc2, jx, jf = jstep.decoder_decode_ee(jm, jp, jc, jnp.asarray(tok), jnp.asarray(pos), thr)
    tl, tc2, tx, tf = tm.decode_step_ee(tp, {k: v.clone() for k, v in tc.items()}, torch.as_tensor(tok),
                                        torch.as_tensor(pos), thr)
    _close(tl, jl)
    assert tx.tolist() == np.asarray(jx).tolist() and 1 in tx.tolist() and max(tx.tolist()) > 1
    _close(tf, jf)
    _close_cache(tc2, jc2)
    W = 3
    thrs = np.full((3, W), thr, np.float32)
    jout = jstep.decoder_decode_spec(jm, jp, jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(thrs), W)
    tout = tm.decode_step_spec(tp, {k: v.clone() for k, v in tc.items()}, torch.as_tensor(tok),
                               torch.as_tensor(pos), torch.as_tensor(thrs), W)
    assert tout[0].tolist() == np.asarray(jout[0]).tolist()
    _close(tout[1], jout[1])
    _close_cache(tout[2], jout[2])
    for k in (3, 5):
        assert tout[k].tolist() == np.asarray(jout[k]).tolist()
    _close(tout[4], jout[4])


# ---------------------------------------------------------------------------
# where the quantize kernel is reached
# ---------------------------------------------------------------------------


def _count(module, name, fn):
    calls = []
    real = getattr(module, name)

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(module, name, counting)
    try:
        fn()
    finally:
        setattr(module, name, real)
    return len(calls)


@pytest.mark.parametrize("arch", ARCHS)
def test_act_quantize_reached_where_the_jax_package_passes_use_pallas(arch):
    """Calls reaching ``dispatch.act_quantize`` per entry point on the
    kernel route, in both packages: the dense and MoE decode methods (one
    call per layer) and the serving prefill of those families (one per
    layer and token); none for any other family's decode methods (their
    layers take no ``use_pallas`` in the JAX package) and none in
    ``prefill``, the training forward or token exit.  The JAX package
    scans its layers, so it traces one call where the port makes n_layers:
    the two are compared as reached or not."""
    jm, tm, jp, tp, cfg = setup(arch)
    n, L_ = cfg.n_layers, 4
    dense = cfg.family in ("dense", "moe")
    batch, (_, jc), (_, tc) = _prefilled(arch, B=2, S=4)
    tok = batch["tokens"][:, 4:5]
    jaux, taux = _aux(cfg, batch)

    def fresh():
        return {k: v.clone() for k, v in tc.items()}

    entries = {
        "decode_step": (lambda: jm.decode_step(jp, jc, jnp.asarray(tok), 4, use_pallas=True),
                        lambda: tm.decode_step(tp, fresh(), torch.as_tensor(tok), 4, use_kernels=True), n),
        "prefill": (lambda: jm.prefill(jp, jnp.asarray(batch["tokens"][:, :4]), jm.init_cache(2, 16), aux=jaux),
                    lambda: tm.prefill(tp, torch.as_tensor(batch["tokens"][:, :4]), tm.init_cache(2, 16, device="cpu"),
                                       aux=taux), 0),
        "apply_train": (lambda: jm.apply_train(jp, {k: jnp.asarray(v) for k, v in batch.items()}),
                        lambda: tm.apply_train(tp, {k: torch.as_tensor(v) for k, v in batch.items()}), 0),
        "serving_prefill": (
            lambda: jstep.decoder_prefill(jm, jp, jm.init_cache(2, 16), jnp.asarray(batch["tokens"][0, :8]), 0,
                                          L_ + 1, 2, use_pallas=True),
            lambda: tstep.decoder_prefill(tm, tp, tm.init_cache(2, 16, device="cpu"), batch["tokens"][0, :8], 0,
                                          L_ + 1, use_kernels=True), n * L_),
    }
    if dense:
        entries["decode_step_ee"] = (
            lambda: jm.decode_step_ee(jp, jc, jnp.asarray(tok), 4, 1.0, use_pallas=True),
            lambda: tm.decode_step_ee(tp, fresh(), torch.as_tensor(tok), 4, 1.0, use_kernels=True), n)
        one = {k: v[:, :1] for k, v in jc.items()}
        entries["decode_step_spec"] = (
            lambda: jm.decode_step_spec(jp, one, jnp.asarray(tok[:1]), 4, 1.0, 2, use_pallas=True),
            lambda: tm.decode_step_spec(tp, fresh(), torch.as_tensor(tok), 4, 1.0, 2, use_kernels=True), 2 * n)
        entries["forward_token_exit"] = (
            lambda: jm.forward_token_exit(jp, jnp.asarray(batch["tokens"]), 1.0),
            lambda: tm.forward_token_exit(tp, batch["tokens"], 1.0), 0)
    for name, (jfn, tfn, want) in entries.items():
        want = want if dense else 0
        got_t = _count(tdispatch, "act_quantize", tfn)
        got_j = _count(jdispatch, "act_quantize", jfn)
        assert got_t == want, (name, got_t, want)
        assert (got_j > 0) == (want > 0), (name, got_j)
