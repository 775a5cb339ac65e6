"""Weight bridge between the JAX package's parameter trees and the port.

* ``params_from_numpy`` turns a nested dict of numpy arrays (a JAX param
  tree passed through ``np.asarray``) into the same tree of torch tensors;
  ``params_to_numpy`` goes back (port-trained weights into the JAX package).
* ``load_npz_checkpoint`` reads a ``step_N/arrays.npz`` written by either
  package's checkpoint manager, whose keys are ``jax.tree_util.keystr``
  paths such as ``['layer']['attn']['wq']`` or, for the AdamW state of the
  generic training route, ``['opt'].m['layer']['attn']['wq']``, without
  importing JAX.
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

# one path segment: a dict key ['name'] or a NamedTuple field .name
_SEGMENT = re.compile(r"\['([^'\\]*)'\]|\.([A-Za-z_][A-Za-z0-9_]*)")


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


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors -> the same tree of numpy arrays on the host.  A
    bfloat16 leaf comes back as float32 (numpy has no bfloat16; the
    widening is exact)."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(conv(v) for v in node))
        t = torch.as_tensor(node).detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return conv(tree)


def parse_keystr(key: str) -> list:
    """``"['layer']['attn']['wq']"`` -> ``['layer', 'attn', 'wq']``: the keystr
    path of a leaf.  NamedTuple fields (``"['opt'].m['embed']['tok']"``, the
    AdamW state's ``count`` / ``m`` / ``v``) read as keys too, so the
    checkpoint loads as nested dicts."""
    parts, pos = [], 0
    for m in _SEGMENT.finditer(key):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(1) is not None else m.group(2))
        pos = m.end()
    if not parts or pos != len(key):
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
