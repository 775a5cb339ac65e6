"""The Fig. 6 pipeline of ``test_system.py`` (phase 1 with magnitude
pruning and span learning, phase 2 off-ramp training, AdaptivFloat-8
post-quantization, eNVM embedding storage, early-exit serving), trained by
both packages from the same weights (the JAX package's init, bridged), and
the port's ``launch/finetune.py``.

Tolerances: per-step losses within 1e-4 relative and trained params within
1e-4 (observed ~1e-7: float32 sums in another order).  Training runs with
activation quantization off: an AdaptivFloat rounding boundary turns a
last-ulp difference into a whole quantum that every later step carries
(``test_torch_training.py`` holds the quantized step's gradients on a
batch free of such boundaries).  Serving uses the shipped config, with
activation quantization: the JAX-trained weights, quantized and read back
from the eNVM by the JAX package and bridged, serve in the port with the
same exits as the JAX ``ClassifierServer`` and logits within 2e-4, at a
threshold at least 1e-3 from every observed entropy (SyntheticCLS seed 0,
step 777: no element lands on an AF boundary).
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
from repro.core import envm as jenvm
from repro.core import pruning as jpruning
from repro.core.adaptivfloat import AFFormat as JAF
from repro.core.adaptivfloat import encode_pytree as j_encode_pytree
from repro.core.adaptivfloat import quantize_pytree as j_quantize_pytree
from repro.data.synthetic import SyntheticCLS as JData
from repro.models.model import build_model as j_build
from repro.serving.engine import ClassifierServer as JServer
from repro.serving.engine import Request as JRequest
from repro.training.optim import AdamWConfig as JAdam
from repro.training.train_loop import EdgeBertTrainer as JTrainer
from repro.training.train_loop import TrainerConfig as JTC
from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.configs.base import PruneConfig as TPrune
from repro_torch.configs.base import SpanConfig as TSpan
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core import pruning as tpruning
from repro_torch.core.adaptivfloat import AFFormat as TAF
from repro_torch.core.adaptivfloat import encode_pytree as t_encode_pytree
from repro_torch.core.adaptivfloat import quantize_pytree as t_quantize_pytree
from repro_torch.data.synthetic import SyntheticCLS as TData
from repro_torch.launch import finetune
from repro_torch.models.model import build_model as t_build
from repro_torch.serving.engine import ClassifierServer, Request
from repro_torch.training.optim import AdamWConfig as TAdam
from repro_torch.training.train_loop import EdgeBertTrainer as TTrainer
from repro_torch.training.train_loop import TrainerConfig as TTC

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4
LOGIT_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (the suite runs parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, P, S, quant, threshold=None):
    c = dataclasses.replace(get("albert_edgebert"), dtype="float32", remat_policy="none")
    c = c.with_edgebert(
        prune=P(enabled=True, method="magnitude", encoder_sparsity=0.4, embedding_sparsity=0.5,
                end_step=25, update_every=5),
        span=S(enabled=True, max_span=128, ramp=16, loss_coef=0.02, init_span=96.0),
        quant=dataclasses.replace(c.edgebert.quant, enabled=quant))
    if threshold is not None:
        c = c.with_edgebert(early_exit=dataclasses.replace(c.edgebert.early_exit, entropy_threshold=threshold))
    return c


def _pick_threshold(entropies, min_gap=1e-3):
    e = np.unique(np.asarray(entropies, np.float64))
    mids = [(a + b) / 2 for a, b in zip(e, e[1:]) if b - a > 2 * min_gap]
    assert mids, "no gap wide enough between observed entropies"
    return float(min(mids, key=lambda m: abs(m - np.median(e))))


def _drain(server, tokens):
    R = JRequest if isinstance(server, JServer) else Request
    for i, t in enumerate(tokens):
        server.submit(R(uid=i, tokens=t))
    stats = server.run()
    return server, stats


@pytest.fixture(scope="module")
def trained():
    jcfg, tcfg = _cfg(j_smoke, JPrune, JSpan, False), _cfg(t_smoke, TPrune, TSpan, False)
    jparams = j_build(jcfg).init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jtr = JTrainer(j_build(jcfg), JTC(phase1_steps=35, phase2_steps=25,
                                      opt=JAdam(lr=2e-3, warmup_steps=3, total_steps=60)))
    ttr = TTrainer(t_build(tcfg), TTC(phase1_steps=35, phase2_steps=25,
                                      opt=TAdam(lr=2e-3, warmup_steps=3, total_steps=60)))
    jdata, tdata = (JData(jcfg.vocab_size, 32, 8, num_classes=3, seed=0),
                    TData(tcfg.vocab_size, 32, 8, num_classes=3, seed=0))
    jp1, jstate, jh1 = jtr.phase1(jparams, jdata, log_every=1000)
    tp1, tstate, th1 = ttr.phase1(tparams, tdata, log_every=1000)
    jp2, jh2 = jtr.phase2(jp1, jdata, log_every=1000)
    tp2, th2 = ttr.phase2(tp1, tdata, log_every=1000)
    return dict(jcfg=jcfg, tcfg=tcfg, jdata=jdata, tdata=tdata, jstate=jstate, tstate=tstate,
                j=(jp1, jh1, jp2, jh2), t=(tp1, th1, tp2, th2))


def test_training_matches(trained):
    jp1, jh1, jp2, jh2 = trained["j"]
    tp1, th1, tp2, th2 = trained["t"]
    for t_hist, j_hist in ((th1, jh1), (th2, jh2)):
        assert len(t_hist) == len(j_hist)
        for step, (t, j) in enumerate(zip(t_hist, j_hist)):
            assert abs(t["loss"] - j["loss"]) <= LOSS_RTOL * abs(j["loss"]), (step, t["loss"], j["loss"])
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jp2)[0]}
    for path, leaf in tree_leaves_with_path(tp2):
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=PARAM_ATOL, rtol=0, err_msg=path)
    got = tpruning.measured_sparsity(tp1, trained["tstate"])["sparsity"]
    assert got == pytest.approx(jpruning.measured_sparsity(jp1, trained["jstate"])["sparsity"], abs=1e-3)
    assert got > 0.3 and np.isfinite(th2[-1]["loss"])
    assert float(tp2["span_z"].mean()) < 96.0       # the regularizer shrank the spans


def _deploy_jax(jp2, seed=1):
    q = j_quantize_pytree(jp2, JAF(8, 3), predicate=lambda path, leaf: "norm" not in str(path).lower())
    rb, _ = jenvm.store_and_readback(np.asarray(q["embed"]["tok"]), data_cell="MLC2", seed=seed)
    return dict(q, embed=dict(q["embed"], tok=jnp.asarray(rb)))


def test_quantize_pytree_matches(trained):
    """AF(8, 3) of every leaf but the norms, on the same (JAX-trained) tree:
    the same grid values, and the norms untouched; and every leaf's
    storage form (codes, e_min) equal."""
    jp2 = trained["j"][2]
    pred_j = lambda path, leaf: "norm" not in str(path).lower()      # noqa: E731
    jq = j_quantize_pytree(jp2, JAF(8, 3), predicate=pred_j)
    tq = t_quantize_pytree(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp2), "cpu"), TAF(8, 3),
                           predicate=lambda path, _: "norm" not in path.lower())
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(jq)[0]}
    for path, leaf in tree_leaves_with_path(tq):
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
    assert torch.equal(tq["layer"]["norm1"]["scale"], torch.from_numpy(np.array(jp2["layer"]["norm1"]["scale"])))
    je = j_encode_pytree(jp2, JAF(8, 3))
    te = t_encode_pytree(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp2), "cpu"), TAF(8, 3))
    for (jpath, (jc, je_min)), (tpath, tpair) in zip(
            jax.tree_util.tree_flatten_with_path(je, is_leaf=lambda x: isinstance(x, tuple))[0],
            _encoded_leaves(te)):
        assert jax.tree_util.keystr(jpath) == tpath
        np.testing.assert_array_equal(tpair[0].numpy(), np.asarray(jc), err_msg=tpath)
        assert int(tpair[1]) == int(je_min), tpath


def _encoded_leaves(tree, prefix=""):
    """(keystr path, (codes, e_min)) of an encode_pytree result, in JAX's order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in _encoded_leaves(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def test_jax_trained_weights_serve_in_port(trained):
    """The JAX-trained, deployed weights, bridged: the port's ClassifierServer
    (kernel route, plain versions on the CPU) gives the JAX server's exits."""
    params_q = _deploy_jax(trained["j"][2])
    tokens = list(JData(trained["jcfg"].vocab_size, 32, 8, num_classes=3, seed=0).batch(777)["tokens"])
    jq = _cfg(j_smoke, JPrune, JSpan, True, threshold=0.0)
    prof, _ = _drain(JServer(j_build(jq), params_q, batch_lanes=4), tokens)
    thr = _pick_threshold(np.concatenate([prof.done[i].entropy_trace for i in range(len(tokens))]))
    jsrv, jstats = _drain(JServer(j_build(_cfg(j_smoke, JPrune, JSpan, True, thr)), params_q, batch_lanes=4),
                          tokens)
    tcfg = _cfg(t_smoke, TPrune, TSpan, True, thr)
    tsrv, tstats = _drain(ClassifierServer(t_build(tcfg), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params_q), device="cpu"), batch_lanes=4, device="cpu"), tokens)
    for i in range(len(tokens)):
        assert tsrv.done[i].exit_layer == jsrv.done[i].exit_layer, i
        np.testing.assert_allclose(tsrv.done[i].result, np.asarray(jsrv.done[i].result), atol=LOGIT_ATOL)
    assert tstats["sentences"] == jstats["sentences"] == 8
    assert tstats["avg_exit_layer"] == pytest.approx(jstats["avg_exit_layer"], rel=1e-12)
    assert len({jsrv.done[i].exit_layer for i in range(8)}) > 1      # the threshold splits the mix


def test_port_pipeline_serves_its_own_weights(trained):
    """The port's own trained weights through its deploy steps
    (``launch.finetune``'s ``quantize_for_deploy`` and ``serve_trained``):
    every sentence served at a valid exit, and the quantized, eNVM-read
    model about as accurate as the trained one (test_system's check)."""
    tcfg = _cfg(t_smoke, TPrune, TSpan, True)
    model = t_build(tcfg)
    tp2 = trained["t"][2]
    params_q, stats = finetune.quantize_for_deploy(tp2, seed=1)
    assert stats["compression"] > 1.0
    served = finetune.serve_trained(model, params_q, trained["tdata"].batch(777)["tokens"][:8], "cpu")
    assert served["sentences"] == 8 and 1.0 <= served["avg_exit_layer"] <= tcfg.n_layers
    batch = {k: torch.as_tensor(v) for k, v in trained["tdata"].batch(999).items() if k != "signal_ratio"}
    acc = lambda p: float((model.apply_train(p, batch).cls_logits.argmax(-1) == batch["labels"]).float().mean())  # noqa: E731
    assert acc(params_q) >= acc(tp2) - 0.25


def test_finetune_cli_runs_on_cpu():
    out = finetune.main(["--device", "cpu", "--steps", "12"])
    assert len(out["phase1"]) == 12 and len(out["phase2"]) == 6
    assert out["served"]["sentences"] == 16 and len(out["deployed_exits"]) == 16
    assert out["sparsity"] > 0.3
