"""Logical-axis sharding rules for every parameter family (the port of
``repro/sharding/rules.py``, MaxText-style).

Each parameter leaf is matched by path substring to a tuple of LOGICAL axis
names per dimension; a per-arch ``logical_to_mesh`` table maps logical axes
to mesh axes.  Divisibility is enforced at assignment time: a logical axis
whose dimension does not divide the mesh axis size degrades to replicated
(this is what handles kv_heads=4/8 on a 16-way model axis, and 60 experts on
qwen2-moe via its expert-TP override).  Stacked-layer leaves get leading
replicated dims.

Every assignment is a ``Sharding``: ``spec``, a tuple equal entry for entry
to the JAX package's ``PartitionSpec`` (a mesh axis name, a tuple of names,
or None per dim; ``()`` is replicated), and, when the mesh is a
``DeviceMesh``, ``placements``, the DTensor placements of the same layout
(a mesh axis on a dim is ``Shard(dim)`` on that mesh dim; a tuple of axes
such as ``("pod", "data")`` shards the dim over each of them, slowest
first, as ``PartitionSpec`` does; anything else is ``Replicate()``).
``distribute`` places a tree by them, the counterpart of
``jax.device_put(params, param_shardings(...))``.

The rules match slash-joined names (``layers/mlp/w_up``); the port's trees
walk by keystr paths (``['layers']['mlp']['w_up']``), which ``path_to_str``
converts.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from repro_torch.common.util import tree_map, tree_map_with_path
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import MeshLike, axis_sizes

# ---------------------------------------------------------------------------
# path-pattern -> logical axes (per trailing dim)
# ---------------------------------------------------------------------------

# order matters: first match wins
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("embed/tok", ("vocab", "embed_small")),
    ("embed/proj", ("embed_small", None)),
    ("embed/pos", (None, None)),
    ("enc_pos", (None, None)),
    ("lm_head", (None, "vocab")),
    # attention
    ("attn/wq", (None, "heads_out")),
    ("attn/wk", (None, "kv_out")),
    ("attn/wv", (None, "kv_out")),
    ("attn/wo", ("heads_out", None)),
    ("attn/bq", ("heads_out",)),
    ("attn/bk", ("kv_out",)),
    ("attn/bv", ("kv_out",)),
    ("xattn/wq", (None, "heads_out")),
    ("xattn/wk", (None, "kv_out")),
    ("xattn/wv", (None, "kv_out")),
    ("xattn/wo", ("heads_out", None)),
    ("xattn/bq", ("heads_out",)),
    ("xattn/bk", ("kv_out",)),
    ("xattn/bv", ("kv_out",)),
    # MoE (3D expert-stacked)
    ("moe/router", (None, None)),
    ("moe/w_gate", ("experts", None, "moe_ffn")),
    ("moe/w_up", ("experts", None, "moe_ffn")),
    ("moe/w_down", ("experts", "moe_ffn", None)),
    ("shared/w_gate", (None, "ffn")),
    ("shared/w_up", (None, "ffn")),
    ("shared/w_down", ("ffn", None)),
    ("shared/gate_proj", (None, None)),
    # dense MLP
    ("mlp/w_gate", (None, "ffn")),
    ("mlp/w_up", (None, "ffn")),
    ("mlp/w_down", ("ffn", None)),
    # rwkv6
    ("tmix/w_r", (None, "heads_out")),
    ("tmix/w_k", (None, "heads_out")),
    ("tmix/w_v", (None, "heads_out")),
    ("tmix/w_g", (None, "heads_out")),
    ("tmix/w_o", ("heads_out", None)),
    ("cmix/w_k", (None, "ffn")),
    ("cmix/w_v", ("ffn", None)),
    ("cmix/w_r", (None, None)),
    # mamba2
    ("mixer/w_in", (None, "ssm_inner")),
    ("mixer/w_out", ("ssm_inner_in", None)),
    ("mixer/conv_w", (None, None)),
    # zamba shared attn out projection
    ("shared_attn/out_proj", ("heads_out", None)),
    # classifiers / off-ramps / norms / scalars: replicated
)

STACK_MARKERS = ("layers", "cross_layers", "enc_layers", "dec_cross")

Spec = Tuple[Any, ...]


@dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or None). Per-arch overridable."""

    table: Dict[str, Any] = field(
        default_factory=lambda: {
            "vocab": "model",
            "heads_out": "model",
            "kv_out": "model",
            "ffn": "model",
            "moe_ffn": None,          # MoE default: experts sharded instead
            "experts": "model",
            "ssm_inner": "model",
            "ssm_inner_in": "model",
            "embed_small": None,
            "batch": ("pod", "data"),
            "cache_batch": "data",
            "cache_seq": None,
            "cache_kv": "model",
        }
    )

    def mesh_axis(self, logical: Optional[str]):
        if logical is None:
            return None
        return self.table.get(logical)


@dataclass(frozen=True)
class Sharding:
    """One leaf's layout: the ``PartitionSpec`` entries, and the DTensor
    placements when the mesh is a ``DeviceMesh`` (else None)."""

    spec: Spec
    placements: Optional[Tuple[Placement, ...]] = None


def _size(sizes: Dict[str, int], ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes.get(ax, 1)


def rules_for(cfg: ModelConfig, mesh: MeshLike, shape: Optional[ShapeConfig] = None) -> ShardingRules:
    """Arch- and shape-specific rule table."""
    table = dict(ShardingRules().table)
    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    # batch axes present in this mesh
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    table["batch"] = dp_axes if len(dp_axes) > 1 else (dp_axes[0] if dp_axes else None)

    if cfg.family == "moe":
        if cfg.n_experts % model_size == 0:
            table["experts"] = "model"
            table["moe_ffn"] = None
        else:
            # qwen2-moe: 60 experts don't divide 16 -> expert-TP on ffn dim
            table["experts"] = None
            table["moe_ffn"] = "model"

    if cfg.ssm_replicated:
        table["ssm_inner"] = None
        table["ssm_inner_in"] = None

    if shape is not None:
        dp_total = _size(sizes, dp_axes) if dp_axes else 1
        if shape.kind in ("decode", "prefill"):
            if shape.global_batch % dp_total == 0 and shape.global_batch >= dp_total:
                table["cache_batch"] = table["batch"]
                table["cache_seq"] = None
            else:
                # batch-1 long-context decode: shard the KV sequence instead
                # (flash-decode style)
                table["cache_batch"] = None
                table["cache_seq"] = table["batch"]
    return ShardingRules(table=table)


def placements_of(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of a ``PartitionSpec``-style ``spec`` on ``mesh``:
    per mesh dim, ``Shard(d)`` where the dim's axis shards tensor dim d, else
    ``Replicate()``.  A tuple of axes on one dim must list them in mesh
    order (slowest first), the order in which DTensor splits a dim that
    several mesh dims shard."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def sharding_for(spec: Spec, mesh: MeshLike) -> Sharding:
    """The ``Sharding`` of ``spec`` on ``mesh`` (placements on a DeviceMesh)."""
    return Sharding(tuple(spec), placements_of(tuple(spec), mesh) if isinstance(mesh, DeviceMesh) else None)


# ---------------------------------------------------------------------------
# Param tree -> Sharding tree
# ---------------------------------------------------------------------------


def _spec_for_leaf(path: str, shape: Tuple[int, ...], rules: ShardingRules, mesh: MeshLike) -> Spec:
    sizes = axis_sizes(mesh)
    for pat, logical_axes in PARAM_RULES:
        if pat in path:
            n_stack_dims = len(shape) - len(logical_axes)
            spec: list = [None] * n_stack_dims
            for dim, logical in zip(shape[n_stack_dims:], logical_axes):
                ax = rules.mesh_axis(logical)
                if ax is None:
                    spec.append(None)
                    continue
                spec.append(ax if dim % _size(sizes, ax) == 0 else None)
            return tuple(spec)
    return ()  # replicated (norms, scalars, classifiers, off-ramps)


_SEGMENT = re.compile(r"\['([^'\\]*)'\]|\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]")


def path_to_str(path: str) -> str:
    """``"['layers']['mlp']['w_up']"`` (a keystr path, as the port's tree
    walk gives it) -> ``'layers/mlp/w_up'`` (rules match on slash-joined
    names, as the JAX package's ``path_to_str`` makes them)."""
    parts, pos = [], 0
    for m in _SEGMENT.finditer(path):
        if m.start() != pos:
            break
        parts.append(next(g for g in m.groups() if g is not None))
        pos = m.end()
    if pos != len(path):
        raise ValueError(f"unparseable tree path {path!r}")
    return "/".join(parts)


def param_shardings(params: Any, mesh: MeshLike, rules: ShardingRules) -> Any:
    """Tree of ``Sharding`` matching ``params`` (meta tensors will do)."""

    def assign(path, leaf):
        if not hasattr(leaf, "shape"):
            return sharding_for((), mesh)
        return sharding_for(_spec_for_leaf(path_to_str(path), tuple(leaf.shape), rules, mesh), mesh)

    return tree_map_with_path(assign, params)


# ---------------------------------------------------------------------------
# Batch / cache shardings
# ---------------------------------------------------------------------------


def batch_shardings(batch: Any, mesh: MeshLike, rules: ShardingRules) -> Any:
    """tokens/labels [B, S] or [B] -> batch over dp axes; aux embeds too."""
    b_ax = rules.mesh_axis("batch")
    size = _size(axis_sizes(mesh), b_ax)

    def assign(leaf):
        nd = len(leaf.shape)
        if nd and b_ax is not None and leaf.shape[0] % size == 0:
            return sharding_for((b_ax,) + (None,) * (nd - 1), mesh)
        return sharding_for((), mesh)

    return tree_map(assign, batch)


def cache_shardings(cache: Any, mesh: MeshLike, rules: ShardingRules, cfg: ModelConfig) -> Any:
    """Decode caches: [L, B, S, KV, hd] (k/v), mamba/rwkv states, etc."""
    cb = rules.mesh_axis("cache_batch")
    cs = rules.mesh_axis("cache_seq")
    kv_ax = rules.mesh_axis("cache_kv")
    sizes = axis_sizes(mesh)

    def sz(ax):
        return _size(sizes, ax)

    def assign(path, leaf):
        pstr = path_to_str(path)
        parts = pstr.split("/")
        shape = leaf.shape
        spec: list = [None] * len(shape)
        if any(key in parts for key in ("k", "v", "img_k", "img_v", "enc_k", "enc_v")):
            # [L, B, S, KV, hd]
            if cb is not None and shape[1] % sz(cb) == 0 and shape[1] >= sz(cb):
                spec[1] = cb
            if cs is not None and shape[2] % sz(cs) == 0:
                spec[2] = cs
            if kv_ax is not None and shape[3] % sz(kv_ax) == 0:
                spec[3] = kv_ax
            elif kv_ax is not None and spec[2] is None and shape[2] % sz(kv_ax) == 0:
                # kv_heads don't divide the model axis (GQA kv=4/8 on 16-way):
                # shard the SEQUENCE dim over model instead of replicating
                spec[2] = kv_ax
        elif any(key in parts for key in ("conv", "ssm", "last_tm", "last_cm", "wkv")):
            # [L, B, ...] state tensors: shard batch; wkv heads over model
            if cb is not None and shape[1] % sz(cb) == 0 and shape[1] >= sz(cb):
                spec[1] = cb
            if "wkv" in pstr or "ssm" in pstr:
                if kv_ax is not None and len(shape) > 2 and shape[2] % sz(kv_ax) == 0:
                    spec[2] = kv_ax
        return sharding_for(tuple(spec), mesh)

    return tree_map_with_path(assign, cache)


def logical_to_mesh(rules: ShardingRules, *logical: Optional[str]) -> Spec:
    return tuple(rules.mesh_axis(name) for name in logical)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def distribute(tree: Any, shardings: Any, mesh: DeviceMesh) -> Any:
    """``tree`` placed on ``mesh`` by ``shardings`` (a tree of ``Sharding``
    with placements, as ``param_shardings`` gives on a ``DeviceMesh``): a
    plain tensor becomes a DTensor (every rank passes the same full tensor;
    rank 0's is scattered), a DTensor moves to its new placements (the
    ZeRO-1 step gathers its updated params back this way)."""

    def place(leaf: torch.Tensor, sh: Sharding):
        if sh.placements is None:
            raise ValueError("distribute needs shardings computed on a DeviceMesh")
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, sh.placements)
        return distribute_tensor(leaf, mesh, sh.placements)

    return tree_map(place, tree, shardings)
