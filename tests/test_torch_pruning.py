"""Movement and magnitude pruning, port against the JAX package: the cases
of ``test_pruning.py``, each run through both packages on the same numpy
inputs (schedule, masks, block masks, the straight-through gradients, the
excluded leaves, ``measured_sparsity``), and the prunable leaf set of a real
ALBERT param tree.

Tolerances: the schedule is compared bit for bit (both compute it in
float32 with the same operations); masks exactly (the scores here have no
two values within 1e-6 of each other, so no element sits on a threshold
tie); gradients and scores within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core import pruning as jp
from repro.models.model import build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.core import pruning as tp

ATOL = 1e-6


def _w(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


class TestMasks:
    def test_magnitude_mask_sparsity(self):
        w = _w(0, (64, 64))
        m = tp.magnitude_mask(_t(w), 0.75).numpy()
        np.testing.assert_array_equal(m, np.asarray(jp.magnitude_mask(jnp.asarray(w), 0.75)))
        assert abs(m.mean() - 0.25) < 0.02
        assert np.abs(w)[m == 1].min() >= np.abs(w)[m == 0].max() - 1e-6

    def test_zero_sparsity_keeps_all(self):
        w = _w(1, (32, 32))
        m = tp.magnitude_mask(_t(w), 0.0).numpy()
        np.testing.assert_array_equal(m, np.asarray(jp.magnitude_mask(jnp.asarray(w), 0.0)))
        assert m.mean() == 1.0

    @pytest.mark.parametrize("shape,block", [((64, 64), 16), ((96, 80), 32)])
    def test_block_mask_structure(self, shape, block):
        """block_size > 1 prunes whole (b, b) tiles (ragged edges too)."""
        w = _w(2, shape)
        m = tp.magnitude_mask(_t(w), 0.5, block_size=block).numpy()
        np.testing.assert_array_equal(m, np.asarray(jp.magnitude_mask(jnp.asarray(w), 0.5, block_size=block)))
        r, c = -(-shape[0] // block), -(-shape[1] // block)
        padded = np.pad(m, ((0, r * block - shape[0]), (0, c * block - shape[1])), constant_values=-1)
        for tile in padded.reshape(r, block, c, block).transpose(0, 2, 1, 3).reshape(r * c, -1):
            assert len(set(tile[tile >= 0])) == 1

    def test_schedule_cubic(self):
        for step in (0, 1, 7, 50, 99, 100, 200):
            for final, begin, end in ((0.8, 0, 100), (0.5, 5, 37), (0.6, 0, 0)):
                got = tp.sparsity_schedule(step, final, begin, end)
                want = np.float32(jp.sparsity_schedule(step, final, begin, end))
                assert got.dtype == torch.float32
                assert got.numpy() == want, (step, final, begin, end)
        s = [float(tp.sparsity_schedule(k, 0.8, 0, 100)) for k in (0, 50, 100, 200)]
        assert s[0] == 0.0 and abs(s[2] - 0.8) < 1e-6 and s[3] == s[2]
        assert s[1] > 0.8 / 2  # cubic front-loads sparsification


class TestMovement:
    def test_ste_gradients(self):
        """dL/dscores = dL/d(masked_w) * w (straight-through); dL/dw = g * mask."""
        w = np.array([[1.0, -2.0], [0.5, 3.0]], np.float32)
        s = np.array([[1.0, 4.0], [2.0, 3.0]], np.float32)
        gw_j, gs_j = jax.grad(lambda a, b: jnp.sum(jp.movement_masked_weight(a, b, 0.5) * 2.0),
                              argnums=(0, 1))(jnp.asarray(w), jnp.asarray(s))
        wt, st = _t(w).requires_grad_(), _t(s).requires_grad_()
        (tp.movement_masked_weight(wt, st, 0.5) * 2.0).sum().backward()
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=ATOL)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), atol=ATOL)
        np.testing.assert_allclose(wt.grad.numpy(), 2.0 * tp.topv_mask(_t(s), 0.5).numpy())
        np.testing.assert_allclose(st.grad.numpy(), 2.0 * w)

    def test_ste_block_gradients(self):
        w, s, g = _w(3, (64, 48)), np.abs(_w(4, (64, 48))), _w(5, (64, 48))
        gw_j, gs_j = jax.grad(lambda a, b: jnp.sum(jp.movement_masked_weight(a, b, 0.5, 16) * g),
                              argnums=(0, 1))(jnp.asarray(w), jnp.asarray(s))
        wt, st = _t(w).requires_grad_(), _t(s).requires_grad_()
        out = tp.movement_masked_weight(wt, st, 0.5, 16)
        np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jp.movement_masked_weight(w, s, 0.5, 16)))
        (out * _t(g)).sum().backward()
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j), atol=ATOL)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs_j), atol=ATOL)

    def test_movement_differs_from_magnitude(self):
        """Movement keeps weights moving AWAY from zero even if small now."""
        w = np.array([0.01, 1.0, -0.02, 0.5], np.float32)
        scores = np.array([10.0, -5.0, 8.0, -2.0], np.float32)
        mv = tp.topv_mask(_t(scores), 0.5).numpy()
        mag = tp.magnitude_mask(_t(w), 0.5).numpy()
        np.testing.assert_array_equal(mv, np.asarray(jp.topv_mask(jnp.asarray(scores), 0.5)))
        assert (mv != mag).any() and mv[0] == 1 and mv[2] == 1

    def test_movement_scores_update(self):
        tree = {"layers": {"attn": {"wq": _w(6, (16, 16))}}, "norm1": {"scale": np.ones(16, np.float32)}}
        grads = {"layers": {"attn": {"wq": _w(7, (16, 16))}}, "norm1": {"scale": _w(8, (16,))}}
        params = {"layers": {"attn": {"wq": _w(9, (16, 16))}}, "norm1": {"scale": np.ones(16, np.float32)}}
        js = jp.update_movement_scores(jp.init_prune_state(tree, "movement"), params, grads, 0.01)
        ts = tp.update_movement_scores(tp.init_prune_state(params_from_numpy(tree, "cpu"), "movement"),
                                       params_from_numpy(params, "cpu"), params_from_numpy(grads, "cpu"), 0.01)
        np.testing.assert_allclose(ts.scores["layers"]["attn"]["wq"].numpy(),
                                   np.asarray(js.scores["layers"]["attn"]["wq"]), atol=ATOL)
        assert ts.scores["norm1"]["scale"] is None and js.scores["norm1"]["scale"] is None
        jm = jp.update_masks(params, js, 10, "movement", 0.5, 0, 10)
        tm = tp.update_masks(params_from_numpy(params, "cpu"), ts, 10, "movement", 0.5, 0, 10)
        np.testing.assert_array_equal(tm.masks["layers"]["attn"]["wq"].numpy(),
                                      np.asarray(jm.masks["layers"]["attn"]["wq"]))


class TestTreePlumbing:
    def _params(self):
        k = np.random.default_rng(3)
        return {
            "layers": {"attn": {"wq": k.standard_normal((16, 16)).astype(np.float32)}},
            "norm1": {"scale": np.ones((16,), np.float32)},
            "offramp_cls_w": k.standard_normal((16, 4)).astype(np.float32),
        }

    def test_excludes_norm_and_offramp(self):
        """Paper §IV-B2: LN / off-ramp / classifier stay dense."""
        p = self._params()
        js = jp.update_masks(p, jp.init_prune_state(p, "magnitude"), 1000, "magnitude", 0.9, 0, 10)
        pt = params_from_numpy(p, "cpu")
        ts = tp.update_masks(pt, tp.init_prune_state(pt, "magnitude"), 1000, "magnitude", 0.9, 0, 10)
        masked = tp.apply_masks(pt, ts)
        jmasked = jp.apply_masks(p, js)
        for path, leaf in tree_leaves_with_path(masked):
            want = dict((jax.tree_util.keystr(k), v) for k, v in jax.tree_util.tree_flatten_with_path(jmasked)[0])
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want[path]))
        assert masked["norm1"]["scale"].numpy().all()
        assert (masked["offramp_cls_w"].numpy() != 0).all()
        assert (masked["layers"]["attn"]["wq"].numpy() == 0).mean() > 0.8

    def test_measured_sparsity(self):
        p = self._params()
        js = jp.update_masks(p, jp.init_prune_state(p, "magnitude"), 1000, "magnitude", 0.5, 0, 10)
        pt = params_from_numpy(p, "cpu")
        ts = tp.update_masks(pt, tp.init_prune_state(pt, "magnitude"), 1000, "magnitude", 0.5, 0, 10)
        got, want = tp.measured_sparsity(pt, ts), jp.measured_sparsity(p, js)
        assert got == want
        assert 0.4 < got["sparsity"] < 0.6

    def test_prunable_leaves_of_albert_match(self):
        """The same keystr paths are pruned in both packages (the exclusion
        list matches substrings of those strings); the embedding table
        ['embed']['tok'] is prunable in both."""
        cfg = dataclasses.replace(j_smoke("albert_edgebert"), dtype="float32")
        jparams = build_model(cfg).init_params(jax.random.PRNGKey(0))
        want = {jax.tree_util.keystr(p) for p, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]
                if jp.prunable(jp.path_str(p), leaf)}
        tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
        got = {path for path, leaf in tree_leaves_with_path(tparams) if tp.prunable(tp.path_str(path), leaf)}
        assert got == want
        assert "['embed']['tok']" in got and not any("offramp" in g or "norm" in g for g in got)
        # the whole walk: same paths, same order as jax.tree_util
        assert [p for p, _ in tree_leaves_with_path(tparams)] == [
            jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
