"""Checkpoints, port against the JAX package: the cases of
``test_checkpoint.py`` on the port's ``checkpoint/manager.py``, and
checkpoints written by either package restored by the other, bit for bit,
including the generic training route's AdamW state (keys
``['opt'].count``, ``['opt'].m[...]``, ``['opt'].v[...]``), which
``launch/train.py`` resumes from.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.configs.base import get_smoke_config as j_smoke
from repro.models.model import build_model as j_build
from repro.training.optim import adamw_init as j_adamw_init
from repro_torch.bridge import load_npz_checkpoint, params_from_numpy, params_to_numpy
from repro_torch.checkpoint.manager import CheckpointManager, latest_step, restore_checkpoint, save_checkpoint
from repro_torch.common.util import tree_leaves_with_path
from repro_torch.launch import train as t_train
from repro_torch.training.optim import AdamWState, adamw_init


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g), "b": torch.zeros(4)},
        "opt": {"m": torch.ones(8, 4), "count": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return [v for _, v in tree_leaves_with_path(tree)]


class TestSaveRestore:
    def test_roundtrip(self, tmp_path):
        t = _tree()
        save_checkpoint(str(tmp_path), 10, t)
        restored, manifest = restore_checkpoint(str(tmp_path), t)
        assert manifest["step"] == 10
        for a, b in zip(_leaves(t), _leaves(restored)):
            assert torch.equal(a, b) and a.dtype == b.dtype

    def test_latest_pointer(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, _tree())
        save_checkpoint(str(tmp_path), 5, _tree(1))
        assert latest_step(str(tmp_path)) == 5

    def test_integrity_check(self, tmp_path):
        save_checkpoint(str(tmp_path), 3, _tree())
        npz = os.path.join(str(tmp_path), "step_00000003", "arrays.npz")
        with open(npz, "r+b") as f:
            f.seek(100)
            f.write(b"\xde\xad")
        with pytest.raises(IOError):
            restore_checkpoint(str(tmp_path), _tree())

    def test_missing_key_detected(self, tmp_path):
        save_checkpoint(str(tmp_path), 3, {"a": torch.zeros(3)})
        with pytest.raises(KeyError):
            restore_checkpoint(str(tmp_path), {"a": torch.zeros(3), "b": torch.zeros(2)})

    def test_elastic_dtype_cast(self, tmp_path):
        """Restore recasts to the target tree's dtype (a bf16 run restoring
        an fp32-written checkpoint) and places leaves on the target's device."""
        save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4, 4)})
        restored, _ = restore_checkpoint(str(tmp_path), {"w": torch.zeros(4, 4, dtype=torch.bfloat16)})
        assert restored["w"].dtype == torch.bfloat16 and restored["w"].device.type == "cpu"
        assert torch.equal(restored["w"].float(), torch.ones(4, 4))

    def test_no_partial_checkpoint_visible(self, tmp_path):
        """A .tmp dir must never be considered a checkpoint."""
        os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
        assert latest_step(str(tmp_path)) is None


class TestManager:
    def test_cadence_and_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2)
        for step in range(1, 8):
            mgr.maybe_save(step, _tree(step))
        dirs = sorted(d for d in os.listdir(str(tmp_path)) if d.startswith("step_"))
        assert len(dirs) == 2  # GC keeps 2
        assert mgr.latest_step() == 6

    def test_preemption_forces_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_every=1000)
        mgr.simulate_preemption()
        assert mgr.preempted
        path = mgr.maybe_save(3, _tree())
        assert path is not None and mgr.latest_step() == 3
        assert not mgr.preempted  # cleared after save

    def test_resume_matches(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), save_every=1)
        t = _tree(9)
        mgr.maybe_save(4, t)
        restored, manifest = mgr.restore_latest(t)
        assert manifest["step"] == 4
        assert torch.equal(t["params"]["w"], restored["params"]["w"])


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def _train_state(dtype="float32"):
    """The generic route's checkpoint tree: albert_base smoke params (float32,
    as both launchers train) and an AdamW state with non-trivial moments."""
    cfg = dataclasses.replace(j_smoke("albert_base"), dtype=dtype)
    jparams = j_build(cfg).init_params(jax.random.PRNGKey(0))
    jopt = j_adamw_init(jparams)
    jopt = jopt._replace(count=jnp.asarray(3, jnp.int32),
                         m=jax.tree_util.tree_map(lambda p: p * 0.5, jparams),
                         v=jax.tree_util.tree_map(lambda p: p * p, jparams))
    return {"params": jparams, "opt": jopt}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_port(tmp_path, dtype):
    jtree = _train_state(dtype)
    jckpt.save_checkpoint(str(tmp_path), 3, jtree)
    np_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                                     else np.asarray(a), jtree)
    tparams = params_from_numpy(np_tree["params"], device="cpu")
    if dtype == "bfloat16":
        tparams = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16), tparams)
    target = {"params": tparams, "opt": adamw_init(tparams)}
    restored, manifest = restore_checkpoint(str(tmp_path), target)
    assert manifest["step"] == 3 and isinstance(restored["opt"], AdamWState)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(np_tree)[0]}
    got = dict(tree_leaves_with_path(restored))
    assert set(got) == set(want)
    assert {"['opt'].count", "['opt'].m['layer']['attn']['wq']", "['opt'].v['embed']['tok']"} <= set(got)
    for k, v in want.items():
        assert got[k].dtype == (torch.bfloat16 if k.startswith("['params']") and dtype == "bfloat16"
                                else torch.from_numpy(np.array(v)).dtype), k
        assert np.array_equal(got[k].float().numpy() if got[k].is_floating_point() else got[k].numpy(), v), k
    if dtype == "bfloat16":
        return
    # and untyped, through the bridge: the attribute keys read as dict keys
    tree = load_npz_checkpoint(os.path.join(str(tmp_path), "step_00000003"))
    assert int(tree["opt"]["count"]) == 3
    np.testing.assert_array_equal(tree["opt"]["m"]["layer"]["attn"]["wq"], want["['opt'].m['layer']['attn']['wq']"])


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree = _train_state()
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    tparams = params_from_numpy(np_tree["params"], device="cpu")
    topt = AdamWState(count=torch.tensor(3, dtype=torch.int32),
                      m=params_from_numpy(np_tree["opt"].m, "cpu"), v=params_from_numpy(np_tree["opt"].v, "cpu"))
    save_checkpoint(str(tmp_path), 3, {"params": tparams, "opt": topt})
    with open(os.path.join(str(tmp_path), "step_00000003", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["keys"] == sorted(jax.tree_util.keystr(p) for p, _ in
                                      jax.tree_util.tree_flatten_with_path(jtree)[0])
    restored, _ = jckpt.restore_checkpoint(str(tmp_path), jtree)
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(jtree)[0], jax.tree_util.tree_leaves(restored)):
        assert np.asarray(b).dtype == np.asarray(a).dtype and np.array_equal(np.asarray(a), np.asarray(b)), p
    # params_to_numpy goes back the other way too
    back = params_to_numpy({"params": tparams, "opt": topt})
    np.testing.assert_array_equal(back["opt"].m["layer"]["mlp"]["w_up"], np_tree["opt"].m["layer"]["mlp"]["w_up"])


def test_generic_route_resumes_from_jax_checkpoint(tmp_path):
    """A JAX checkpoint of the generic route (params + AdamW state, step 3)
    resumes in the port's launch/train.py, which trains on from step 3."""
    jckpt.save_checkpoint(str(tmp_path), 3, _train_state())
    before = signal.getsignal(signal.SIGTERM)
    try:
        out = t_train.main(["--arch", "albert_base", "--smoke", "--device", "cpu", "--steps", "5",
                            "--batch", "4", "--seq", "32", "--save-every", "100", "--ckpt-dir", str(tmp_path)])
    finally:
        signal.signal(signal.SIGTERM, before)
    assert out["route"] == "generic" and out["start_step"] == 3
    assert int(out["opt"].count) == 5 and latest_step(str(tmp_path)) == 5
    assert np.isfinite(out["final"]["loss"])
