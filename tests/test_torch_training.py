"""Training, port against the JAX package: AdamW and its schedules, the
losses, the soft span ramp's gradient, ``make_train_step`` with and without
microbatches, the two phases of ``EdgeBertTrainer`` (magnitude, movement,
with a teacher), a fully masked attention row under autograd, and the
kernel wrappers' refusal of inputs autograd would record through.

The JAX package initialises the smoke ``albert_edgebert`` params; the
bridge brings them across; both packages train from them on the same
``SyntheticCLS`` batches.

Tolerances: one AdamW update within 1e-6 (float32 arithmetic in the same
order); losses within 1e-4 relative and params within 1e-4 over ~10 steps
(observed about 1e-7 relative: float32 sums in another order).  The
multi-step trajectories run with activation quantization off: an
AdaptivFloat rounding boundary turns a last-ulp difference into a whole
quantum, which then carries through every later step (on these batches the
first such flip comes within 1-3 steps, and the losses then part by
~1e-3); the quantized path (its straight-through gradient) is held on one
batch on which no element lands on a boundary.  Masks are
compared under the tie rule: an element (or tile) may differ only where its
score lies within 1e-6 of the threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import PruneConfig as JPrune
from repro.configs.base import SpanConfig as JSpan
from repro.configs.base import get_smoke_config as j_smoke
from repro.core import distill as jdistill
from repro.core.adaptive_span import span_soft_mask as j_span_soft_mask
from repro.core import pruning as jpruning
from repro.data.synthetic import SyntheticCLS as JData
from repro.models import layers as jlayers
from repro.models.model import build_model as j_build
from repro.training import losses as jlosses
from repro.training import optim as joptim
from repro.training.train_loop import EdgeBertTrainer as JTrainer
from repro.training.train_loop import TrainerConfig as JTrainerConfig
from repro.training.train_loop import make_loss_fn as j_loss_fn
from repro.training.train_loop import make_train_step as j_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import assert_finite, tree_leaves_with_path
from repro_torch.configs.base import PruneConfig as TPrune
from repro_torch.configs.base import SpanConfig as TSpan
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core import adaptive_span, distill
from repro_torch.core import pruning as tpruning
from repro_torch.data.synthetic import SyntheticCLS as TData
from repro_torch.kernels import build, layernorm
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model as t_build
from repro_torch.training import losses as tlosses
from repro_torch.training import optim as toptim
from repro_torch.training.train_loop import EdgeBertTrainer as TTrainer
from repro_torch.training.train_loop import TrainerConfig as TTrainerConfig
from repro_torch.training.train_loop import make_loss_fn as t_loss_fn
from repro_torch.training.train_loop import make_train_step as t_train_step
from repro_torch.training.train_loop import to_batch, value_and_grad

ATOL = 1e-6
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
TIE = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: the smoke-size steps are many
    tiny ops, and under the suite's parallel workers torch's default pool
    per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(quant=False, prune=None, span=None, distill_alpha=0.0):
    out = []
    for get, P, S in ((j_smoke, JPrune, JSpan), (t_smoke, TPrune, TSpan)):
        c = dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
        eb = dict(quant=dataclasses.replace(c.edgebert.quant, enabled=quant), distill_alpha=distill_alpha,
                  prune=P(**prune) if prune else P(enabled=False),
                  span=S(**span) if span else c.edgebert.span)
        out.append(c.with_edgebert(**eb))
    return out


def _init(jcfg, seed=0):
    jparams = j_build(jcfg).init_params(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _jflat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tflat(tree):
    return {p: v.detach().numpy() for p, v in tree_leaves_with_path(tree)}


def _assert_trees_close(ttree, jtree, atol):
    got, want = _tflat(ttree), _jflat(jtree)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def _assert_losses_close(t_hist, j_hist, keys=("loss",)):
    assert len(t_hist) == len(j_hist)
    for step, (t, j) in enumerate(zip(t_hist, j_hist)):
        for k in keys:
            assert abs(t[k] - j[k]) <= LOSS_RTOL * abs(j[k]), (step, k, t[k], j[k])


def _block_scores(score, block):
    if block <= 1:
        return score
    r, c = score.shape
    s = np.pad(score, ((0, (-r) % block), (0, (-c) % block)))
    return np.sqrt((s.reshape(s.shape[0] // block, block, s.shape[1] // block, block) ** 2).sum(axis=(1, 3)))


def _assert_masks_match(t_masks, j_masks, scores, sparsity, block):
    """Masks equal except where the score (the reference's) lies within
    ``TIE`` of the threshold: the tie rule."""
    want = _jflat(j_masks)
    got = _tflat(t_masks)
    assert set(got) == set(want)
    for path, m in got.items():
        bs = _block_scores(np.abs(scores[path]) if block else scores[path], block)
        flat = np.sort(bs.reshape(-1))
        k = int(np.floor(np.float32(flat.size) * np.float32(sparsity)))
        near = np.zeros_like(bs, bool) if k <= 0 else np.abs(bs - flat[k - 1]) <= TIE
        if block > 1:
            near = np.repeat(np.repeat(near, block, 0), block, 1)[: m.shape[0], : m.shape[1]]
        bad = (m != want[path]) & ~near
        assert not bad.any(), (path, int(bad.sum()))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, 1e6])
def test_adamw_update_matches(schedule, clip):
    """Two updates (count 1 and 2: the bias corrections) of the smoke ALBERT
    tree, with weight decay on the decay mask's leaves and the span LR
    multiplier; the global-norm clip engaged (1.0) or not (1e6)."""
    jcfg, _ = _cfgs(span=dict(enabled=True, init_span=64.0))
    jparams, tparams = _init(jcfg)
    rng = np.random.default_rng(11)
    grads = [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.3, jparams)
             for _ in range(2)]
    kw = dict(lr=2e-3, warmup_steps=3, total_steps=10, schedule=schedule, grad_clip_norm=clip,
              weight_decay=0.01, span_lr_mult=300.0)
    jo, to = joptim.AdamWConfig(**kw), toptim.AdamWConfig(**kw)
    js, ts = joptim.adamw_init(jparams), toptim.adamw_init(tparams)
    jp_, tp_ = jparams, tparams
    for g in grads:
        jp_, js, jm = joptim.adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp_, jo)
        tp_, ts, tm = toptim.adamw_update(params_from_numpy(g, "cpu"), ts, tp_, to)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= ATOL * abs(float(jm["lr"]))
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= ATOL * float(jm["grad_norm"])
    _assert_trees_close(tp_, jp_, ATOL)
    _assert_trees_close(ts.m, js.m, ATOL)
    _assert_trees_close(ts.v, js.v, ATOL)
    assert int(ts.count) == int(js.count) == 2
    assert all(not t.requires_grad for _, t in tree_leaves_with_path(tp_))


def test_lr_schedules_and_decay_mask():
    for schedule in ("cosine", "linear", "constant"):
        jc = joptim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
        tc = toptim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule=schedule)
        for step in (0, 1, 5, 10, 37, 99, 100, 150):
            want = float(joptim.lr_schedule(jc, jnp.array(step)))
            assert abs(float(toptim.lr_schedule(tc, torch.tensor(step))) - want) <= ATOL * max(abs(want), 1e-30)
    tc = toptim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(toptim.lr_schedule(tc, torch.tensor(0))) == 0.0
    assert abs(float(toptim.lr_schedule(tc, torch.tensor(10))) - 1.0) < 1e-6
    assert float(toptim.lr_schedule(tc, torch.tensor(100))) < 1e-6
    # the same leaves get weight decay in both packages
    jcfg, _ = _cfgs(span=dict(enabled=True))
    jparams, tparams = _init(jcfg)
    want = {jax.tree_util.keystr(p) for p, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
            if joptim._decay_mask(p, leaf)}
    got = {p for p, leaf in tree_leaves_with_path(tparams) if toptim._decay_mask(p, leaf)}
    assert got == want and "['layer']['norm1']['scale']" not in got and "['span_z']" not in got


def test_adamw_minimizes_quadratic():
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    cfg = toptim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1, total_steps=200)
    state = toptim.adamw_init(params)
    for _ in range(200):
        (_, _), grads = value_and_grad(lambda p: (((p["w"] - target) ** 2).sum(), None), params)
        params, state, _ = toptim.adamw_update(grads, state, params, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=0.05)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def test_losses_match():
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((6, 3)).astype(np.float32) * 2
    tlg = rng.standard_normal((6, 3)).astype(np.float32) * 2
    labels = rng.integers(0, 3, 6).astype(np.int32)
    all_lg = rng.standard_normal((4, 6, 3)).astype(np.float32)
    lm = rng.standard_normal((2, 9, 17)).astype(np.float32)
    toks = rng.integers(0, 17, (2, 9)).astype(np.int32)
    z = (rng.uniform(0, 128, (1, 4))).astype(np.float32)
    T = torch.from_numpy

    def close(got, want):
        assert abs(float(got) - float(want)) <= ATOL * max(1.0, abs(float(want))), (float(got), float(want))

    close(distill.kd_loss(T(lg), T(tlg)), jdistill.kd_loss(lg, tlg))
    close(distill.kd_loss(T(lg), T(tlg), 4.0), jdistill.kd_loss(lg, tlg, 4.0))
    close(distill.cross_entropy(T(lg), T(labels)), jdistill.cross_entropy(lg, labels))
    close(distill.distill_objective(T(lg), T(tlg), T(labels), 0.5), jdistill.distill_objective(lg, tlg, labels, 0.5))
    for (tv, tm), (jv, jm) in ((tlosses.lm_loss(T(lm), T(toks)), jlosses.lm_loss(lm, toks)),
                               (tlosses.cls_loss(T(lg), T(labels)), jlosses.cls_loss(lg, labels))):
        close(tv, jv)
        close(tm["acc"], jm["acc"])
    close(tlosses.offramp_loss(T(all_lg), T(labels)), jlosses.offramp_loss(all_lg, labels))
    for kw in (dict(), dict(teacher=True, distill_alpha=0.5), dict(span=True, span_coef=0.05)):
        args = dict(distill_alpha=kw.get("distill_alpha", 0.0), span_coef=kw.get("span_coef", 0.0), max_span=128)
        tv, tm = tlosses.edgebert_phase1_loss(T(lg), T(labels), teacher_logits=T(tlg) if kw.get("teacher") else None,
                                              span_z=T(z) if kw.get("span") else None, **args)
        jv, jm = jlosses.edgebert_phase1_loss(lg, labels, teacher_logits=tlg if kw.get("teacher") else None,
                                              span_z=z if kw.get("span") else None, **args)
        close(tv, jv)
        assert set(tm) == set(jm)
        for k in jm:
            close(tm[k], jm[k])
    close(adaptive_span.span_loss(T(z), 128, 0.05), jnp.asarray(0.05) * jnp.mean(z) / 128.0)
    np.testing.assert_array_equal(adaptive_span.clamp_spans(T(z - 64), 32).numpy(),
                                  np.asarray(jnp.clip(z - 64, 0.0, 32.0)))


# ---------------------------------------------------------------------------
# The soft span ramp's gradient at its bounds
# ---------------------------------------------------------------------------


def test_clip01_gradient_at_bounds_matches_jnp_clip():
    x = np.array([-0.5, 0.0, 0.25, 1.0, 1.5], np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(jnp.clip(a, 0.0, 1.0) * jnp.arange(1.0, 6.0)))(x))
    xt = torch.from_numpy(x).requires_grad_()
    (adaptive_span.clip01(xt) * torch.arange(1.0, 6.0)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    assert want[1] == 0.5 * 2.0 and want[3] == 0.5 * 4.0    # half the gradient at a bound
    z = np.array([3.0, 6.0], np.float32)                     # integer spans: ties at d = z and z + ramp
    weights = jnp.arange(2 * 12 * 12, dtype=jnp.float32).reshape(2, 12, 12)
    jg = jax.grad(lambda a: jnp.sum(weights * j_span_soft_mask(a, 12, 12, 4, causal=False)))(z)
    zt = torch.from_numpy(z).requires_grad_()
    (torch.arange(2 * 12 * 12, dtype=torch.float32).reshape(2, 12, 12) *
     adaptive_span.span_soft_mask(zt, 12, 12, 4, causal=False)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jg), rtol=1e-6)


def _span_grad(tcfg, tparams, batch):
    (_, _), g = value_and_grad(t_loss_fn(t_build(tcfg)), tparams, to_batch(batch, "cpu"))
    return g["span_z"].numpy()


def test_span_z_gradient_at_integer_span_matches(monkeypatch):
    """With an integer init_span (16, ramp 16) and integer distances the soft
    ramp sits exactly on its upper bound at d = z, so span_z's first
    gradient depends on the clip's gradient there: the port's equals JAX's
    0.5-weighted value, and ``torch.clamp``'s (all of it) would not."""
    jcfg, tcfg = _cfgs(span=dict(enabled=True, max_span=128, ramp=16, loss_coef=0.05, init_span=16.0))
    jparams, tparams = _init(jcfg)
    batch = JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=0).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "signal_ratio"}
    (_, _), jg = jax.value_and_grad(j_loss_fn(j_build(jcfg)), has_aux=True)(jparams, jb)
    want = np.asarray(jg["span_z"])
    got = _span_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    monkeypatch.setattr(tlayers, "clip01", lambda x: x.clamp(0.0, 1.0))
    clamped = _span_grad(tcfg, tparams, batch)
    assert np.abs(clamped - want).max() > 100 * np.abs(got - want).max() + 1e-7


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatches", [1, 4])
def test_make_train_step_matches(microbatches):
    jcfg, tcfg = _cfgs(span=dict(enabled=True, init_span=64.0))
    jparams, tparams = _init(jcfg)
    batch = JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=1).batch(0)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    jf = jax.jit(j_train_step(j_build(jcfg), joptim.AdamWConfig(**kw), microbatches=microbatches))
    tf = t_train_step(t_build(tcfg), toptim.AdamWConfig(**kw), microbatches=microbatches)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "signal_ratio"}
    jp_, js, jm = jparams, joptim.adamw_init(jparams), None
    tp_, ts, tm = tparams, toptim.adamw_init(tparams), None
    for _ in range(2):
        jp_, js, jm = jf(jp_, js, jb)
        tp_, ts, tm = tf(tp_, ts, to_batch(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert set(tm) == set(jm)
    _assert_trees_close(tp_, jp_, PARAM_ATOL)
    if microbatches > 1:
        one = t_train_step(t_build(tcfg), toptim.AdamWConfig(**kw))(tparams, toptim.adamw_init(tparams),
                                                                     to_batch(batch, "cpu"))[0]
        four = tf(tparams, toptim.adamw_init(tparams), to_batch(batch, "cpu"))[0]
        d = max(np.abs(a - b).max() for a, b in zip(_tflat(one).values(), _tflat(four).values()))
        assert d < 5e-3     # the same data: nearly the same update


# ---------------------------------------------------------------------------
# EdgeBertTrainer
# ---------------------------------------------------------------------------

PHASE1_STEPS = 10
SPAN = dict(enabled=True, max_span=128, ramp=16, loss_coef=0.05, init_span=96.0)
OPT = dict(lr=2e-3, warmup_steps=3, total_steps=20, span_lr_mult=300.0)


def _phase1_both(prune, distill_alpha=0.0, quant=False, steps=PHASE1_STEPS, data_seed=0):
    jcfg, tcfg = _cfgs(quant=quant, prune=prune, span=SPAN, distill_alpha=distill_alpha)
    jparams, tparams = _init(jcfg)
    jteach = tteach = None
    if distill_alpha:
        jteach, tteach = _init(jcfg, seed=5)
    jtr = JTrainer(j_build(jcfg), JTrainerConfig(phase1_steps=steps, phase2_steps=0,
                                                 opt=joptim.AdamWConfig(**OPT)), teacher_params=jteach)
    ttr = TTrainer(t_build(tcfg), TTrainerConfig(phase1_steps=steps, phase2_steps=0,
                                                 opt=toptim.AdamWConfig(**OPT)), teacher_params=tteach)
    last = {}
    jout = jtr.phase1(jparams, JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=data_seed), log_every=1000,
                      callbacks=[lambda step, p, m: last.update(params=p)])
    tout = ttr.phase1(tparams, TData(tcfg.vocab_size, 32, 8, num_classes=3, seed=data_seed), log_every=1000)
    return jcfg, jout, tout, last["params"]


@pytest.mark.parametrize("method,block,alpha", [("magnitude", 1, 0.0), ("magnitude", 16, 0.0),
                                                ("movement", 1, 0.0), ("magnitude", 1, 0.5)],
                         ids=["magnitude", "magnitude_block16", "movement", "magnitude_teacher"])
def test_phase1_matches(method, block, alpha):
    prune = dict(enabled=True, method=method, encoder_sparsity=0.5, embedding_sparsity=0.5,
                 end_step=8, update_every=3, block_size=block)
    jcfg, (jp_, jstate, jhist), (tp_, tstate, thist), j_last = _phase1_both(prune, alpha)
    _assert_losses_close(thist, jhist, keys=("loss", "task_loss", "span_loss", "mean_span", "grad_norm", "lr"))
    _assert_trees_close(tp_, jp_, PARAM_ATOL)
    s = float(jpruning.sparsity_schedule(PHASE1_STEPS - 1, 0.5, 0, 8))
    scores = _jflat(jstate.scores) if method == "movement" else _jflat(j_last)
    _assert_masks_match(tstate.masks, jstate.masks, scores, s, block if method == "magnitude" else 1)
    got = tpruning.measured_sparsity(tp_, tstate)
    assert abs(got["sparsity"] - jpruning.measured_sparsity(jp_, jstate)["sparsity"]) < 1e-3
    assert got["sparsity"] > 0.4
    assert all(not t.requires_grad for _, t in tree_leaves_with_path(tp_))


def test_phase1_gradient_with_activation_quant_matches():
    """The shipped config's activation fake-quant (straight-through
    gradient) in the phase-1 loss with a teacher: the loss, and every
    gradient within 1e-5 of its leaf's largest.  On this batch (SyntheticCLS
    seed 2) no element lands on an AF rounding boundary; on seeds 1 and 3
    one does, and the gradients then part by up to ~7e-5."""
    data_seed = 2
    jcfg, tcfg = _cfgs(quant=True, span=SPAN, distill_alpha=0.5)
    jparams, tparams = _init(jcfg)
    jteach, tteach = _init(jcfg, seed=5)
    batch = JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=data_seed).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "signal_ratio"}
    jm, tm = j_build(jcfg), t_build(tcfg)
    jtl = jm.apply_train(jteach, jb).all_cls_logits[-1]
    (jl, _), jg = jax.value_and_grad(j_loss_fn(jm), has_aux=True)(jparams, jb, teacher_logits=jtl)
    tb = to_batch(batch, "cpu")
    with torch.no_grad():
        ttl = tm.apply_train(tteach, tb).all_cls_logits[-1]
    (tl, _), tg = value_and_grad(t_loss_fn(tm), tparams, tb, teacher_logits=ttl)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    got = _tflat(tg)
    for k, want in _jflat(jg).items():
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=k)


def test_phase2_matches_and_freezes_backbone():
    jcfg, tcfg = _cfgs()
    jparams, tparams = _init(jcfg, seed=1)
    kw = dict(lr=2e-3, warmup_steps=3, total_steps=30)
    jtr = JTrainer(j_build(jcfg), JTrainerConfig(phase1_steps=0, phase2_steps=12, opt=joptim.AdamWConfig(**kw)))
    ttr = TTrainer(t_build(tcfg), TTrainerConfig(phase1_steps=0, phase2_steps=12, opt=toptim.AdamWConfig(**kw)))
    jp2, jhist = jtr.phase2(jparams, JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=1))
    tp2, thist = ttr.phase2(tparams, TData(tcfg.vocab_size, 32, 8, num_classes=3, seed=1))
    _assert_losses_close(thist, jhist, keys=("loss", "grad_norm", "lr"))
    assert thist[-1]["loss"] < thist[0]["loss"]
    _assert_trees_close(tp2, jp2, PARAM_ATOL)
    for path, leaf in tree_leaves_with_path(tparams):
        if "offramp" not in path:      # the backbone comes back bit-identical
            assert torch.equal(dict(tree_leaves_with_path(tp2))[path], leaf), path


# ---------------------------------------------------------------------------
# Autograd hazards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [8, 32], ids=["short_path", "chunked_path"])
@pytest.mark.parametrize("span", [False, True])
def test_fully_masked_row_has_finite_gradients(S, span):
    """A row whose keys are all masked (kv_len 0) gives zeros, and autograd
    through the -inf scores and their where() repairs stays finite."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, S, 4, 16)).astype(np.float32)).requires_grad_()
               for _ in range(3))
    z = torch.full((4,), 5.0, requires_grad=True) if span else None
    out = tlayers.attention(q, k, v, causal=False, span_z=z, span_ramp=4, kv_len=torch.tensor([0, S // 2]))
    (out * torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))).sum().backward()
    assert torch.equal(out[0].detach(), torch.zeros_like(out[0]))
    assert_finite({"q": q.grad, "k": k.grad, "v": v.grad, "span_z": z.grad if span else None}, "attention grads ")
    with pytest.raises(AssertionError, match="non-finite values at x\\['q'\\]"):
        assert_finite({"q": q.grad / 0.0}, "x")
    assert torch.equal(q.grad[0], torch.zeros_like(q.grad[0]))
    want = jlayers.attention(jnp.asarray(q.detach().numpy()[1:]), jnp.asarray(k.detach().numpy()[1:]),
                             jnp.asarray(v.detach().numpy()[1:]), causal=False,
                             span_z=None if z is None else jnp.full((4,), 5.0), span_ramp=4, kv_len=S // 2)
    np.testing.assert_allclose(out[1:].detach().numpy(), np.asarray(want), atol=1e-5)


def test_kernel_wrappers_refuse_inputs_autograd_records():
    """Every wrapper validates its CUDA inputs through ``build.require_cuda``,
    which refuses an input autograd would record through (``needs_grad``):
    no kernel has a backward.  On the CPU a wrapper takes its plain version,
    which autograd differentiates."""
    x = torch.randn(4, 8, requires_grad=True)
    g, b = torch.ones(8), torch.zeros(8)
    assert build.needs_grad(x) and build.needs_grad(g, x) and not build.needs_grad(g, b)
    assert not build.needs_grad(x.detach())
    with torch.no_grad():
        assert not build.needs_grad(x)
    with pytest.raises(RuntimeError, match="no backward"):
        build.require_cuda("layernorm", x, g, b)
    with pytest.raises(ValueError, match="CUDA"):      # past the guard, the device check
        build.require_cuda("layernorm", x.detach(), g, b)
    layernorm.layernorm(x, g, b).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_value_and_grad_zero_for_unreached_leaves():
    """Leaves the loss does not reach get zero gradients, as JAX gives them
    (the classifier head when the off-ramp carries the loss)."""
    jcfg, tcfg = _cfgs()
    jparams, tparams = _init(jcfg)
    batch = JData(jcfg.vocab_size, 32, 4, num_classes=3, seed=0).batch(0)
    (_, metrics), grads = value_and_grad(t_loss_fn(t_build(tcfg)), tparams, to_batch(batch, "cpu"))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "signal_ratio"}
    (_, jmetrics), jgrads = jax.value_and_grad(j_loss_fn(j_build(jcfg)), has_aux=True)(jparams, jb)
    assert not grads["classifier"]["cls_w"].any() and not np.asarray(jgrads["classifier"]["cls_w"]).any()
    _assert_trees_close(grads, jgrads, 1e-5)
    assert set(metrics) == set(jmetrics)
    assert all(not t.requires_grad for _, t in tree_leaves_with_path(grads))
