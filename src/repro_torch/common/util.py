"""Small shared utilities: the logger, tree accounting and the walk of
parameter trees by their keystr paths (the port's copy of the JAX package's
``common/util.py``, plus the part of ``jax.tree_util`` the training slice
needs).

A tree is nested dicts and NamedTuples (``AdamWState``, ``PruneState``)
whose leaves are tensors or arrays; ``None`` is an empty subtree, as in JAX.
Leaves are visited in ``jax.tree_util``'s order (dict keys sorted,
NamedTuple fields in declaration order), and each one's path is the string
``jax.tree_util.keystr`` gives it: ``"['layer']['attn']['wq']"``,
``"['opt'].m['embed']['tok']"``.  Pruning, weight decay and checkpoint keys
are decided on those strings, so the port picks the same leaves and writes
the same keys as the JAX package.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

logger = logging.getLogger("repro_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(levelname)s %(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def tree_leaves_with_path(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf), ...]`` in ``jax.tree_util``'s leaf order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in tree_leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for f in tree._fields for item in tree_leaves_with_path(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree) for item in tree_leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, prefix: str = "") -> Any:
    """``tree`` rebuilt with ``fn(path, leaf, *rest_nodes)`` at each leaf;
    ``rest`` are trees whose nodes are taken at the same keys (a rest node at
    a leaf's position is passed as it is, ``None`` included).  ``None`` in
    ``tree`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), prefix=f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                                               prefix=f"{prefix}.{f}") for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest), prefix=f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree, *rest)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree_map_with_path`` without the path."""
    return tree_map_with_path(lambda _, leaf, *r: fn(leaf, *r), tree, *rest)


def tree_num_params(tree: Any) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(np.prod(leaf.shape) if hasattr(leaf, "shape") else 1
                   for _, leaf in tree_leaves_with_path(tree)))


def assert_finite(tree: Any, where: str = "") -> None:
    """Host-side check (tests, eager debugging) that every float leaf is finite."""
    for path, leaf in tree_leaves_with_path(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite values at {where}{path}")


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def tree_size_bytes(tree: Any) -> int:
    """Total byte size of a tree of tensors or arrays (meta tensors too)."""
    return sum(int(np.prod(leaf.shape)) * _itemsize(leaf.dtype)
               for _, leaf in tree_leaves_with_path(tree) if hasattr(leaf, "shape") and hasattr(leaf, "dtype"))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f}{unit}"
        n /= 1024.0
    return f"{n:.2f}PiB"
