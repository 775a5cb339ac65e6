"""Rematerialisation (``remat_policy`` none / dots / full) and the scan's
stacked gradient in the port's training forwards, against the JAX
package's ``Model._remat``.

Every family's smoke config in float32 (the cases of
``test_torch_train_forwards.py``: zamba2 in both forms and at ``ssm_chunk``
2, the vlm's gates nonzero; and albert with early exit off, whose shared
layer is the one scan with a remat region): under "full" and "dots" the
port's loss and every gradient leaf against ``jax.value_and_grad`` of the
JAX model at the same policy, with that file's tolerances (loss 1e-6
relative, each leaf within 1e-4 of its largest magnitude).  The port's
three policies agree bit for bit (no dropout: the region's second run
repeats the first).  What the forward keeps for the backward, measured by
``MemTracker`` on the live tensors after the forward: "full" < "dots" <
"none", and under "full" one layer input more per extra layer.  No
training backward runs ``select_backward`` on a stacked leaf (each leaf
is taken by one ``unbind``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro.training.train_loop import make_loss_fn as j_loss_fn
from repro_torch.bridge import params_to_numpy
from repro_torch.common.util import tree_leaves_with_path, tree_map
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.models import model as TMod
from repro_torch.models.model import build_model as t_build
from repro_torch.models.model import init_params
from repro_torch.training.train_loop import make_loss_fn, value_and_grad
from test_torch_train_forwards import CASES, GATES, IDS, _assert_grads_close, _batch, _j, _t

ALL = CASES + [("albert_edgebert", {})]
ALL_IDS = IDS + ["albert_no_exit"]
STACKED = ("layers", "enc_layers", "dec_cross", "cross_layers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module (see test_torch_decode.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, arch, policy, **kw):
    """float32 at ``policy``; zamba2 at ssm_chunk 2 (the JAX package's
    gradients are NaN at its smoke chunk of 32); albert without exit."""
    cfg = get(arch)
    if arch == "zamba2_1p2b":
        kw = dict(kw, ssm_chunk=2)
    if cfg.family == "albert":
        cfg = cfg.with_edgebert(early_exit=dataclasses.replace(cfg.edgebert.early_exit, enabled=False))
    return dataclasses.replace(cfg, dtype="float32", remat_policy=policy, **kw)


_PARAMS = {}


def _params(arch):
    """(JAX params, port params): one draw per arch by the port's
    ``init_params`` (the JAX tree's keys, shapes and init scales; the
    overrides of CASES change no leaf), the vlm's gates set nonzero, the
    JAX tree bridged from it."""
    if arch not in _PARAMS:
        tp = init_params(_cfg(t_smoke, arch, "none"), torch.Generator().manual_seed(1), device="cpu")
        if "cross_layers" in tp:
            for name, vals in GATES.items():
                tp["cross_layers"][name] = torch.tensor(vals)
        _PARAMS[arch] = (jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tp)), tp)
    return _PARAMS[arch]


def _data(cfg, seed=5):
    batch = _batch(cfg, seed=seed)
    if cfg.family == "albert":
        batch["labels"] = np.random.default_rng(seed).integers(0, cfg.num_classes, (2,))
    return batch


def _port_grads(cfg, tp, batch):
    """(loss, {keystr: gradient}) of the port's ``make_loss_fn``."""
    loss_fn, tb = make_loss_fn(t_build(cfg)), _t(batch)
    (loss, _), g = value_and_grad(lambda p: loss_fn(p, tb), tp)
    return loss, dict(tree_leaves_with_path(g))


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch,kw", ALL, ids=ALL_IDS)
def test_gradients_match_jax_at_the_same_policy(arch, kw, policy):
    jp, tp = _params(arch)
    jcfg, tcfg = _cfg(j_smoke, arch, policy, **kw), _cfg(t_smoke, arch, policy, **kw)
    batch = _data(tcfg)
    (lj, _), gj = jax.jit(jax.value_and_grad(j_loss_fn(j_build(jcfg)), has_aux=True))(jp, _j(batch))
    lt, gt = _port_grads(tcfg, tp, batch)
    assert abs(float(lt) - float(lj)) <= 1e-6 * abs(float(lj))
    _assert_grads_close({k: v.numpy() for k, v in gt.items()},
                        {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(gj)})


@pytest.mark.parametrize("arch,kw", ALL, ids=ALL_IDS)
def test_the_three_policies_agree_bit_for_bit(arch, kw):
    """The loss and every gradient leaf are equal under none, dots and full."""
    _, tp = _params(arch)
    batch = _data(_cfg(t_smoke, arch, "none", **kw))
    (l0, g0), *rest = (_port_grads(_cfg(t_smoke, arch, pol, **kw), tp, batch) for pol in ("none", "dots", "full"))
    for loss, g in rest:
        assert torch.equal(loss, l0)
        assert all(torch.equal(g[k], v) for k, v in g0.items())


def _kept_bytes(arch, policy, **kw):
    """Bytes of the tensors the training forward leaves alive for the
    backward (``MemTracker`` on the CPU, params and batch tracked before the
    forward and left out), with the config and one layer input's bytes."""
    from torch.distributed._tools.mem_tracker import MemTracker

    cfg = dataclasses.replace(t_smoke(arch), dtype="float32", remat_policy=policy, **kw)
    params = tree_map(lambda t: t.requires_grad_(True), init_params(cfg, torch.Generator().manual_seed(0),
                                                                   device="cpu"))
    batch = _t(_batch(cfg))
    loss_fn, mem = make_loss_fn(t_build(cfg)), MemTracker()
    mem.track_external(*(leaf for _, leaf in tree_leaves_with_path(params)), *batch.values())

    def total():
        return sum(v.get("Total", 0) for v in mem.get_tracker_snapshot("current").values())

    with mem:
        before = total()
        loss, _ = loss_fn(params, batch)
        kept = total() - before
    return kept, cfg, batch["tokens"].numel() * cfg.d_model * 4


# one more layer of each family's scan: a group for the vlm (4 layers, one
# of them a cross layer), a block for zamba2 (attn_every 2 at 4 blocks: the
# fifth block has no shared block after it)
MORE = {"llama3_2_vision_90b": 2}


@pytest.mark.parametrize("arch", ["deepseek_7b", "qwen2_moe_a2p7b", "rwkv6_7b", "zamba2_1p2b", "whisper_medium",
                                  "llama3_2_vision_90b"])
def test_full_keeps_less_than_dots_and_dots_less_than_none(arch):
    kept = {pol: _kept_bytes(arch, pol) for pol in ("none", "dots", "full")}
    assert kept["full"][0] < kept["dots"][0] < kept["none"][0], kept
    full, cfg, one_input = kept["full"]
    deeper, _, _ = _kept_bytes(arch, "full", n_layers=cfg.n_layers + MORE.get(arch, 1))
    assert deeper - full == one_input


class _SelectBackwards(TorchDispatchMode):
    """The input sizes of every ``select_backward`` the backward runs."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.select_backward.default:
            self.sizes.append(tuple(args[1]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["none", "full"])
@pytest.mark.parametrize("arch,kw", ALL, ids=ALL_IDS)
def test_no_select_backward_on_a_stacked_leaf(arch, kw, policy):
    """Each stacked leaf (under layers, enc_layers, dec_cross,
    cross_layers, and span_z with a row per layer) gets one [L, ...]
    gradient from unbind, so no backward selects into one: none of the
    ``select_backward`` calls takes a stacked leaf's shape.  Spans on, so
    that span_z has a row per layer."""
    cfg = _cfg(t_smoke, arch, policy, **kw)
    cfg = cfg.with_edgebert(span=dataclasses.replace(cfg.edgebert.span, enabled=True))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    stacked = {tuple(leaf.shape) for path, leaf in tree_leaves_with_path(params)
               if any(f"['{k}']" in path for k in STACKED)}
    if cfg.family in ("dense", "moe", "encdec"):
        # the families that read a span row per layer (the hybrid block
        # and the vlm at init_params' [n_layers, H] read row 0 alone)
        stacked.add(tuple(params["span_z"].shape))
    assert stacked or cfg.family == "albert"
    batch = _t(_data(cfg))
    loss_fn = make_loss_fn(t_build(cfg))
    with torch.enable_grad():
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = loss_fn(live, batch)
        with _SelectBackwards() as mode:
            loss.backward()
    assert not stacked & set(mode.sizes), sorted(stacked & set(mode.sizes))


def test_an_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy 'some'"):
        t_build(dataclasses.replace(t_smoke("deepseek_7b"), remat_policy="some"))


def test_dots_saves_products_by_their_contraction():
    """``x @ w`` lowers to ``mm`` and ``_per_layer_proj``'s einsum to a
    ``bmm`` over a batch of 1, both saved; attention's score product has a
    real batch, recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append((func, args))
            return func(*args, **(kwargs or {}))

    x, w, ws = torch.randn(2, 5, 8), torch.randn(8, 12), torch.randn(3, 8, 12)
    q, k = torch.randn(2, 5, 2, 2, 4), torch.randn(2, 7, 2, 4)
    for fn, want in ((lambda: x @ w, CheckpointPolicy.MUST_SAVE),
                     (lambda: TMod._per_layer_proj(x, ws), CheckpointPolicy.MUST_SAVE),
                     (lambda: torch.einsum("bqkgd,bskd->bqkgs", q, k), CheckpointPolicy.PREFER_RECOMPUTE)):
        with Ops() as mode:
            fn()
        products = [(f, a) for f, a in mode.seen if f in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)]
        assert len(products) == 1
        assert TMod._save_dots(None, products[0][0], *products[0][1]) == want
    assert TMod._save_dots(None, torch.ops.aten.addmm.default, torch.zeros(3), x[0], w) == CheckpointPolicy.MUST_SAVE
    assert TMod._save_dots(None, torch.ops.aten.add.Tensor, x, x) == CheckpointPolicy.PREFER_RECOMPUTE
