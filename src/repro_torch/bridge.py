"""Weight bridge: the JAX package's parameter trees into the port.

* ``params_from_numpy`` turns a nested dict of numpy arrays (a JAX param
  tree passed through ``np.asarray``) into the same tree of torch tensors.
* ``load_npz_checkpoint`` reads a ``step_N/arrays.npz`` written by the JAX
  package's checkpoint manager, whose keys are ``jax.tree_util.keystr``
  paths such as ``['layer']['attn']['wq']``, without importing JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device

_KEY = re.compile(r"\['([^'\\]*)'\]")


def _to_tensor(arr: Any, device: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(arr.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)    # np.array copies: JAX's are read-only


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Nested dicts of arrays -> the same nested dicts of tensors."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(tree)


def parse_keystr(key: str) -> list:
    """``"['layer']['attn']['wq']"`` -> ``['layer', 'attn', 'wq']``: the keystr
    path of a leaf in a tree of dicts, which is what a param tree is."""
    parts = _KEY.findall(key)
    if not parts or "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"unparseable checkpoint key {key!r}")
    return parts


def load_npz_checkpoint(step_dir: str) -> Dict[str, Any]:
    """Read ``<step_dir>/arrays.npz`` into a nested dict of numpy arrays.

    Where a ``manifest.json`` lies beside it, the npz's sha256 is checked
    against the manifest first, as the JAX package's restore does.
    """
    npz_path = os.path.join(step_dir, "arrays.npz")
    manifest_path = os.path.join(step_dir, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            want = json.load(f)["sha256"]
        with open(npz_path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        if got != want:
            raise IOError(f"checkpoint {step_dir} failed integrity check")
    tree: Dict[Any, Any] = {}
    with np.load(npz_path) as data:
        for key in data.files:
            path = parse_keystr(key)
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = data[key]
    return tree
