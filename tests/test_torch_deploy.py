"""The deployed EdgeBERT inference pass, port against the JAX package.

The JAX package initialises the smoke ``albert_edgebert`` params; the weight
bridge brings them across; both packages deploy them and classify the same
seeded sentences (the JAX side runs its Pallas kernels in interpret mode,
the port its kernels' plain versions).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import save_checkpoint
from repro.configs.base import get_smoke_config as j_smoke
from repro.core.early_exit import fit_exit_predictor as j_fit
from repro.models.model import build_model
from repro.serving import dvfs as jdvfs
from repro.serving.deploy import deploy_albert as j_deploy
from repro_torch.bridge import load_npz_checkpoint, params_from_numpy, parse_keystr
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.early_exit import fit_exit_predictor as t_fit
from repro_torch.models.model import init_params
from repro_torch.serving import dvfs as tdvfs
from repro_torch.serving.deploy import deploy_albert as t_deploy

# Logits atol 1e-4: 4 layers of float32 matmuls whose sums run in another
# order, on logits of order 1.  Entropy traces atol 1e-5 for the same reason.
LOGIT_ATOL = 1e-4
TRACE_ATOL = 1e-5


def _cfgs():
    over = dict(dtype="float32", remat_policy="none")
    return (dataclasses.replace(j_smoke("albert_edgebert"), **over),
            dataclasses.replace(t_smoke("albert_edgebert"), **over))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jparams = build_model(jcfg).init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 32))
    return jcfg, tcfg, jparams, np_params, tokens


def _pick_threshold(entropies, min_gap=1e-3):
    """A threshold inside the observed entropies, at least ``min_gap`` from
    every one of them, so float32 noise cannot flip an exit decision: the
    midpoint of the gap nearest the median that is wide enough."""
    e = np.unique(np.asarray(entropies, np.float64))
    mids = [(a + b) / 2 for a, b in zip(e, e[1:]) if b - a > 2 * min_gap]
    assert mids, "no gap wide enough between observed entropies"
    med = np.median(e)
    return float(min(mids, key=lambda m: abs(m - med)))


def test_init_params_tree_matches_jax(setup):
    jcfg, tcfg, jparams, _, _ = setup
    for cfg_t, cfg_j in ((tcfg, jcfg), (t_smoke("albert_edgebert"), j_smoke("albert_edgebert"))):
        want = jax.tree_util.tree_flatten_with_path(build_model(cfg_j).init_params(jax.random.PRNGKey(0)))[0]
        got = init_params(cfg_t, torch.Generator().manual_seed(0), device="cpu")
        flat = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                flat[path] = node

        walk(got, ())
        assert set(flat) == {tuple(k.key for k in p) for p, _ in want}
        for p, leaf in want:
            t = flat[tuple(k.key for k in p)]
            assert tuple(t.shape) == leaf.shape
            assert str(t.dtype).replace("torch.", "") == str(leaf.dtype)


@pytest.mark.parametrize("cell", ["SLC", "MLC2"])
def test_deploy_embeddings_identical(setup, cell):
    """The eNVM readback of the embedding table is bit-identical."""
    jcfg, tcfg, jparams, np_params, _ = setup
    jd = j_deploy(jparams, jcfg, envm_cell=cell, seed=0)
    td = t_deploy(params_from_numpy(np_params, device="cpu"), tcfg, envm_cell=cell, seed=0, device="cpu")
    np.testing.assert_array_equal(td.embed_tok.numpy(), np.asarray(jd.embed_tok))
    np.testing.assert_array_equal(td.spans, jd.spans)
    for name in ("wq", "w_up", "w_down"):
        np.testing.assert_array_equal(td.layer[name].codes.numpy(), np.asarray(jd.layer[name].codes))
        assert td.layer[name].e_min == int(jd.layer[name].e_min)


def _classify_both(jd, td, tokens):
    jl, je = jd.classify(jnp.asarray(tokens))
    tl, te = td.classify(tokens)
    np.testing.assert_allclose(tl, np.asarray(jl), atol=LOGIT_ATOL)
    np.testing.assert_array_equal(te, np.asarray(je))
    for a, b in zip(td.last_entropy_traces, jd.last_entropy_traces):
        np.testing.assert_allclose(a, b, atol=TRACE_ATOL)
    return jl, je


def test_classify_and_dvfs_parity(setup):
    """Profiling pass (threshold 0: every sentence runs all layers), then the
    early-exit pass through classify_with_dvfs: equal exit layers, logits
    and traces within tolerance, and identical DVFS reports."""
    jcfg, tcfg, jparams, np_params, tokens = setup
    jd = j_deploy(jparams, jcfg, envm_cell="MLC2", seed=0)
    td = t_deploy(params_from_numpy(np_params, device="cpu"), tcfg, envm_cell="MLC2", seed=0, device="cpu")
    jd.threshold = td.threshold = 0.0
    _, exits = _classify_both(jd, td, tokens)
    assert (np.asarray(exits) == jcfg.n_layers).all()

    traces = np.asarray(jd.last_entropy_traces)          # [B, L]
    thr = _pick_threshold(traces)
    jd.threshold = td.threshold = thr
    first = traces[:, 0]
    exit_at_thr = np.argmax(np.concatenate([traces < thr, np.ones((len(traces), 1), bool)], 1), 1) + 1
    exit_at_thr = np.minimum(exit_at_thr, jcfg.n_layers)
    target = jdvfs.no_early_exit_baseline(jdvfs.albert_layer_stats(seq_len=32))["latency_s"]
    jctl = jdvfs.default_albert_controller(
        target, seq_len=32, n_layers=jcfg.n_layers, predictor=j_fit(first, exit_at_thr, n_bins=4))
    tctl = tdvfs.default_albert_controller(
        target, seq_len=32, n_layers=tcfg.n_layers, predictor=t_fit(first, exit_at_thr, n_bins=4))
    # the predictor bins the first entropy: keep it away from every bin edge
    assert np.min(np.abs(first[:, None] - tctl.predictor.bin_edges[None])) > 10 * TRACE_ATOL

    jl, je, jrep = jd.classify_with_dvfs(jnp.asarray(tokens), jctl)
    tl, te, trep = td.classify_with_dvfs(tokens, tctl)
    np.testing.assert_array_equal(te, np.asarray(je))
    assert 1 <= te.min() and te.max() <= tcfg.n_layers and te.min() < tcfg.n_layers
    np.testing.assert_allclose(tl, np.asarray(jl), atol=LOGIT_ATOL)
    for a, b in zip(td.last_entropy_traces, jd.last_entropy_traces):
        np.testing.assert_allclose(a, b, atol=TRACE_ATOL)
    for r_t, r_j in zip(trep, jrep):
        assert (r_t.op.vdd, r_t.op.freq_hz) == (r_j.op.vdd, r_j.op.freq_hz)
        assert (r_t.exit_layer, r_t.energy_j, r_t.latency_s, r_t.deadline_met) == (
            r_j.exit_layer, r_j.energy_j, r_j.latency_s, r_j.deadline_met)
    # the shared-clock arbiter path: the same lane reports as the JAX package's
    # (modeled numbers from the same exits and traces, equal to 1e-9 relative)
    deadlines = [None, 2 * target, None, 0.5 * target]
    jl, je, jrep = jd.classify_with_dvfs(jnp.asarray(tokens), jctl, arbiter=jdvfs.BatchedDVFSArbiter(jctl),
                                         deadlines_s=deadlines)
    tl, te, trep = td.classify_with_dvfs(tokens, tctl, arbiter=tdvfs.BatchedDVFSArbiter(tctl),
                                         deadlines_s=deadlines)
    np.testing.assert_array_equal(te, np.asarray(je))
    np.testing.assert_allclose(tl, np.asarray(jl), atol=LOGIT_ATOL)
    assert len(trep) == len(jrep) == len(tokens)
    for r_t, r_j in zip(trep, jrep):
        assert (r_t.exit_layer, r_t.deadline_met, r_t.escalated_layers) == (
            r_j.exit_layer, r_j.deadline_met, r_j.escalated_layers)
        assert (r_t.slowest_op.vdd, r_t.slowest_op.freq_hz) == (r_j.slowest_op.vdd, r_j.slowest_op.freq_hz)
        for f in ("predicted_exit", "latency_s", "energy_j", "target_s"):
            assert getattr(r_t, f) == pytest.approx(getattr(r_j, f), rel=1e-9, abs=0.0)
    with pytest.raises(ValueError, match="another controller"):
        td.classify_with_dvfs(tokens, tctl, arbiter=tdvfs.BatchedDVFSArbiter(
            tdvfs.default_albert_controller(target, seq_len=32, n_layers=tcfg.n_layers)))


def test_classify_mixed_spans(setup):
    """Dead heads gathered out and survivors windowed (tests/test_deploy.py's
    mixed-span case), full depth."""
    jcfg, tcfg, jparams, np_params, tokens = setup
    span_z = np.asarray([[0.0, 24.0, 0.0, 48.0]], np.float32)
    jd = j_deploy(dict(jparams, span_z=jnp.asarray(span_z)), jcfg, envm_cell="SLC")
    td = t_deploy(params_from_numpy(dict(np_params, span_z=span_z), device="cpu"), tcfg,
                  envm_cell="SLC", device="cpu")
    assert list(td.spans) == [0, 24, 0, 48]
    jd.threshold = td.threshold = 0.0
    _classify_both(jd, td, tokens[:2])


def test_npz_checkpoint_round_trip(setup, tmp_path):
    """A checkpoint the JAX package wrote reads back without JAX."""
    _, _, jparams, np_params, _ = setup
    step_dir = save_checkpoint(str(tmp_path), 7, jparams)
    tree = load_npz_checkpoint(step_dir)
    leaves = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(leaves) == sum(1 for _ in _leaves(tree))
    for path, want in leaves:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, want)
    tp = params_from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(tp["layer"]["attn"]["wq"].numpy(), np_params["layer"]["attn"]["wq"])
    assert parse_keystr("['layer']['attn']['wq']") == ["layer", "attn", "wq"]
    # NamedTuple fields (the AdamW state of the training route) read as keys
    assert parse_keystr("['opt'].m['layer']['attn']['wq']") == ["opt", "m", "layer", "attn", "wq"]
    for bad in ("layer/attn", "['a'][3]", "['a'].", "['a']..b", "['a'] .b", ""):
        with pytest.raises(ValueError):
            parse_keystr(bad)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
