"""Fault-tolerant checkpointing (the port of the JAX package's
``checkpoint/manager.py``): atomic commits, integrity hashes, a latest
pointer, preemption hooks, and restore onto the caller's device and dtype.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json  (+ <dir>/LATEST)

The layout and the array keys (``jax.tree_util.keystr`` paths, such as
``['params']['layer']['attn']['wq']`` and ``['opt'].m[...]``) are the JAX
package's, so a checkpoint written by either package restores in the other.
The port writes a bfloat16 leaf as float32 (numpy has no bfloat16; the
widening is exact); the JAX package writes it as raw 2-byte records, which
restore reads back as bfloat16 by the manifest's dtype.  Every leaf comes
back in the target's dtype.

Write protocol (crash-safe): write into step_<N>.tmp/, fsync, atomic rename
to step_<N>/, then rewrite LATEST.  A partly written checkpoint is never
picked up, because LATEST moves only after the rename, and the manifest's
sha256 over the npz guards against torn writes underneath the rename.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.util import logger, tree_leaves_with_path, tree_map_with_path


def _to_numpy(leaf: Any) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {path: _to_numpy(leaf) for path, leaf in tree_leaves_with_path(tree)}


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save_checkpoint(directory: str, step: int, tree: Any, extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    manifest = {
        "step": step,
        "sha256": _sha256(npz_path),
        "keys": sorted(flat.keys()),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "extra": extra or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # move the latest pointer last (atomic via rename)
    latest_tmp = os.path.join(directory, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    logger.info("checkpoint saved: %s (%d arrays)", final, len(flat))
    return final


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(directory, name)):
        return None
    return int(name.split("_")[-1])


def restore_checkpoint(directory: str, target_tree: Any, step: Optional[int] = None,
                       device: Any = None, verify: bool = True) -> Tuple[Any, Dict]:
    """Restore into the structure of ``target_tree``: each leaf in the
    target leaf's dtype, on ``device`` if given, else on the target leaf's
    device (the JAX package's mesh-elastic restore, on one device)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    if verify and _sha256(npz_path) != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")

    with np.load(npz_path) as data:
        missing = [k for k, _ in tree_leaves_with_path(target_tree) if k not in data]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]} (+{max(len(missing) - 5, 0)})")

        def load(key, tgt):
            arr = np.array(data[key])
            if manifest["dtypes"].get(key) == "bfloat16" and arr.dtype.kind == "V":
                arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                arr = torch.from_numpy(arr)
            if torch.is_tensor(tgt):
                return arr.to(device if device is not None else tgt.device, tgt.dtype)
            return arr.to(device) if device is not None else arr

        restored = tree_map_with_path(load, target_tree)
    return restored, manifest


class CheckpointManager:
    """Keeps N checkpoints, auto-resume, preemption-aware saving.

    ``install_preemption_handler()`` hooks SIGTERM: the next ``maybe_save``
    call checkpoints at once (a preempt-save) whatever the cadence, the
    standard behaviour for spot / preemptible fleets.
    """

    def __init__(self, directory: str, save_every: int = 100, keep: int = 3):
        self.directory = directory
        self.save_every = save_every
        self.keep = keep
        self._preempted = threading.Event()

    # ---- preemption ----
    def install_preemption_handler(self):
        def handler(signum, frame):
            logger.warning("SIGTERM received: scheduling preemption checkpoint")
            self._preempted.set()

        signal.signal(signal.SIGTERM, handler)

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    def simulate_preemption(self):
        self._preempted.set()

    # ---- save / restore ----
    def maybe_save(self, step: int, tree: Any, extra=None, force: bool = False) -> Optional[str]:
        if force or self.preempted or (step % self.save_every == 0 and step > 0):
            path = save_checkpoint(self.directory, step, tree, extra)
            self._gc()
            self._preempted.clear()
            return path
        return None

    def restore_latest(self, target_tree: Any, device: Any = None):
        return restore_checkpoint(self.directory, target_tree, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(
            int(d.split("_")[-1])
            for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
