"""The off-ramp head (pooler, classifier, softmax entropy, retire in one
kernel), port against the JAX package.

On the CPU ``softmax_entropy.offramp_head`` takes its plain version
(``ref.offramp_head``), held here against the JAX functions the paths run
around the Pallas softmax-entropy kernel (interpret mode): the serving
step's ``offramp_logits`` + ``dispatch.entropy`` + retire on float32
weights, and the deployed model's ``_offramp_entropy`` on AF8 codes.  The
serving step's kernel route returns views of the head's packed buffer,
which the engine copies back once per step.

Tolerance: atol 1e-5 on logits and entropies (float32 matmul sums in
another order); retire equal wherever the entropy lies at least 1e-4 from
the threshold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_smoke_config as j_smoke
from repro.core.early_exit import OfframpParams as JOfframp
from repro.core.early_exit import offramp_logits as j_offramp_logits
from repro.kernels import dispatch as jdispatch
from repro.models.model import build_model as j_build
from repro.serving.deploy import deploy_albert as j_deploy
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_smoke_config as t_smoke
from repro_torch.core.early_exit import offramp_logits
from repro_torch.core.entropy import entropy_from_logits
from repro_torch.kernels import ops, ref
from repro_torch.kernels.softmax_entropy import offramp_head
from repro_torch.models.model import build_model as t_build
from repro_torch.serving import step_math
from repro_torch.serving.deploy import deploy_albert as t_deploy

ATOL = 1e-5
RETIRE_MARGIN = 1e-4


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_packed(packed, lg, ent, retire, threshold):
    C = lg.shape[1]
    assert packed.shape == (lg.shape[0], C + 2) and packed.dtype == np.float32
    np.testing.assert_allclose(packed[:, :C], lg, atol=ATOL, rtol=0)
    np.testing.assert_allclose(packed[:, C], ent, atol=ATOL, rtol=0)
    assert set(np.unique(packed[:, C + 1])) <= {0.0, 1.0}
    clear = np.abs(np.asarray(ent) - threshold) >= RETIRE_MARGIN
    np.testing.assert_array_equal((packed[:, C + 1] != 0)[clear], np.asarray(retire)[clear])


@pytest.mark.parametrize("B,S,D,C,scale", [(8, 32, 64, 3, 1.0), (16, 4, 96, 2, 3.0), (5, 1, 40, 7, 0.3),
                                            (19, 8, 48, 3, 2.0)])
def test_plain_head_fp32_matches_jax(B, S, D, C, scale):
    """The serving step's off-ramp on float32 weights: offramp_logits, the
    Pallas softmax-entropy kernel (interpret mode), retire = active & (ent <
    threshold), with a threshold at the median entropy and some lanes
    inactive."""
    h = _np((B, S, D), 1, scale)
    w = [_np((D, D), 2, 1 / np.sqrt(D)), _np((D,), 3, 0.1), _np((D, C), 4, 2 / np.sqrt(D)), _np((C,), 5, 0.1)]
    active = np.random.default_rng(6).random(B) < 0.7
    lg = j_offramp_logits(jnp.asarray(h), JOfframp(*map(jnp.asarray, w)))
    ent = np.asarray(jdispatch.entropy(lg))
    thr = float(np.median(ent))
    retire = active & (ent < thr)
    got = offramp_head(_t(h), *map(_t, w), active=_t(active), threshold=thr).numpy()
    _check_packed(got, np.asarray(lg), ent, retire, thr)
    assert 0 < (got[:, C + 1] != 0).sum() < B
    # without a mask every lane is active
    got = offramp_head(_t(h), *map(_t, w), threshold=thr).numpy()
    _check_packed(got, np.asarray(lg), ent, ent < thr, thr)


@pytest.fixture(scope="module")
def deployed():
    cfg = dataclasses.replace(j_smoke("albert_edgebert"), dtype="float32", remat_policy="none")
    tcfg = dataclasses.replace(t_smoke("albert_edgebert"), dtype="float32", remat_policy="none")
    jparams = j_build(cfg).init_params(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    jd = j_deploy(jparams, cfg, envm_cell="MLC2", seed=0)
    td = t_deploy(params_from_numpy(np_params, device="cpu"), tcfg, envm_cell="MLC2", seed=0, device="cpu")
    return jd, td, cfg


@pytest.mark.parametrize("B,S,scale", [(4, 32, 1.0), (16, 8, 4.0), (1, 1, 0.5)])
def test_plain_head_af8_matches_jax_deployed(deployed, B, S, scale):
    """The deployed off-ramp on AF8 codes (pooler and classifier, each with
    its own bias; ops.offramp_head_op, what DeployedAlbert.classify runs)
    against the JAX DeployedAlbert._offramp_entropy (its AF8 matmul and
    softmax-entropy Pallas kernels in interpret mode)."""
    jd, td, cfg = deployed
    h = _np((B, S, cfg.d_model), 7 + B, scale)
    jl, je = jd._offramp_entropy(jnp.asarray(h))
    packed = ops.offramp_head_op(_t(h), td.offramp).numpy()
    _check_packed(packed, np.asarray(jl), np.asarray(je), np.asarray(je) < 0.0, 0.0)
    # the plain version decodes the same codes the kernel reads
    o = td.offramp
    again = ref.offramp_head(_t(h), o["pooler_w"].codes, o["pooler_b"], o["cls_w"].codes, o["cls_b"],
                             e_min=(o["pooler_w"].e_min, o["cls_w"].e_min), fmt=o["pooler_w"].fmt)
    np.testing.assert_array_equal(again.numpy(), packed)


@pytest.mark.parametrize("span", [False, True])
def test_fused_step_kernel_route_packed(span):
    """classifier_fused_step on the kernel route returns (h, logits,
    entropy, retire) as views of one packed buffer, equal to the reference
    route's off-ramp on the same h; classifier_head_step gives that buffer
    itself (what the engine copies to the host once), and unpack_head splits
    a host copy into the same rows."""
    cfg = dataclasses.replace(t_smoke("albert_edgebert"), dtype="float32").with_edgebert(
        span=dataclasses.replace(t_smoke("albert_edgebert").edgebert.span, enabled=span))
    jcfg = dataclasses.replace(j_smoke("albert_edgebert"), dtype="float32").with_edgebert(
        span=dataclasses.replace(j_smoke("albert_edgebert").edgebert.span, enabled=span))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_build(jcfg).init_params(
        jax.random.PRNGKey(1))), device="cpu")
    model = t_build(cfg)
    lanes, S = 4, 16
    h0 = _t(_np((lanes, S, cfg.d_model), 8))
    active = torch.tensor([True, False, True, True])
    lengths = torch.tensor([16, 9, 3, 12], dtype=torch.int32)
    ent0 = entropy_from_logits(offramp_logits(h0, model._offramp(params)))
    thr = float(ent0.median())
    h, lg, ent, retire = step_math.classifier_fused_step(model, params, h0.clone(), active, lengths, thr,
                                                         use_kernels=True)
    assert lg._base is not None and lg._base is ent._base is retire._base
    want_lg = offramp_logits(h, model._offramp(params))
    want_ent = entropy_from_logits(want_lg)
    want_retire = active & (want_ent < thr)
    torch.testing.assert_close(lg, want_lg, atol=ATOL, rtol=0)
    torch.testing.assert_close(ent, want_ent, atol=ATOL, rtol=0)
    assert torch.equal(retire != 0, want_retire)
    assert torch.equal(h[1], h0[1])                 # the inactive lane keeps its state
    h_p, packed = step_math.classifier_head_step(model, params, h0.clone(), active, lengths, thr)
    assert torch.equal(h_p, h) and packed.shape == (lanes, lg.shape[1] + 2)
    host = step_math.unpack_head(packed.numpy())
    np.testing.assert_array_equal(host[0], lg.numpy())
    np.testing.assert_array_equal(host[1], ent.numpy())
    np.testing.assert_array_equal(host[2] != 0, want_retire.numpy())
    # the reference route: three tensors, three copies, the same decisions
    h_r, lg_r, ent_r, retire_r = step_math.classifier_fused_step(model, params, h0.clone(), active, lengths,
                                                                 thr, use_kernels=False)
    assert lg_r._base is None and retire_r.dtype == torch.bool
    clear = (ent_r - thr).abs() >= RETIRE_MARGIN
    assert torch.equal((retire != 0)[clear], retire_r[clear])


def test_head_rejects_mismatched_weights():
    h = torch.zeros(2, 3, 8)
    with pytest.raises(RuntimeError):
        offramp_head(h, torch.zeros(8, 6), torch.zeros(8), torch.zeros(8, 3), torch.zeros(3))
