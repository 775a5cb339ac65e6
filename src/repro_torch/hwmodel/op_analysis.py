"""Per-device cost of a traced step: the port's counterpart of the JAX
package's ``hwmodel/hlo_analysis.py``.

The JAX package compiles a step and parses the per-device HLO text.  The
port makes no HLO (so this module is not called ``hlo_analysis``): it runs
the step, on fake or meta tensors, under ``OpAnalysis``, a
``TorchDispatchMode`` that sees every aten op one rank would run.  It
records, per device:

  * ``flops``: the matmul-class ops (mm, bmm, addmm, baddbmm, convolution,
    scaled-dot-product attention) by ``torch.utils.flop_counter``'s
    formulas, 2·M·N·K for a matmul, on the LOCAL shards: tensor-core work
    only, as ``hlo_analysis`` counts MXU work only (its ``dot``s).  A
    DTensor op is not counted (its local ops are), nor is the op that
    DTensor's sharding propagation runs on global shapes to learn an
    output's shape.
  * ``bytes_io``: 2x the result bytes of each compute op (write + a later
    read), the step's inputs 1x (``add_inputs``), views, metadata ops and
    allocations free.  This is ``hlo_analysis``'s rule without its fusion
    exemptions: eager execution materialises every result.  An in-place
    write into part of a tensor (``copy_``, ``scatter_``, ``index_put_``,
    ``index_copy_``) pays its update, as ``hlo_analysis`` pays a
    dynamic-update-slice its update.
  * ``coll_bytes`` and ``coll_by_kind``: the collectives the step issues
    (DTensor's functional collectives, and the c10d ops of code that calls
    ``torch.distributed`` itself), each ``{"kind", "bytes"}`` of its larger
    side in ``collectives``, weighted by ``roofline.collective_bytes``.
    On a ``"cpu"`` mesh DTensor runs a Shard -> Shard all-to-all as an
    all-gather and a chunk (gloo has no all-to-all); ``OpAnalysis``
    records it as the all-to-all it stands for.
  * ``ops``: a per-op table of count, FLOPs and bytes (``table()`` sorts
    it by bytes).  Ops run inside ``scope(name)`` are filed as
    ``name/op``: the dry run's attention is labelled ``fused_attn_kernel``
    under ``cfg.fused_attention`` (``sharding.dtensor_forms``), as the JAX
    package's named scope does.

A Python loop runs its body n times, so trip counts come for free: what
``hlo_analysis`` has to work out from ``while`` loops the port records
directly, and ``n_while`` / ``max_trip`` stay at 0 and 1.
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common.util import tree_leaves_with_path
from repro_torch.hwmodel.roofline import collective_bytes

_SCOPE: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar("repro_torch_op_scope", default=())
# > 0 inside DTensor's shape propagation or an all-to-all stand-in: ops
# there are no rank's work (the propagation runs on global shapes)
_QUIET: contextvars.ContextVar[int] = contextvars.ContextVar("repro_torch_op_quiet", default=0)


@contextlib.contextmanager
def scope(name: str) -> Iterator[None]:
    """File the ops run inside under ``name/`` in ``OpCosts.ops`` (the
    counterpart of ``jax.named_scope``; nothing else changes)."""
    token = _SCOPE.set(_SCOPE.get() + (name,))
    try:
        yield
    finally:
        _SCOPE.reset(token)


@dataclass
class OpCosts:
    """``hlo_analysis.HloCosts``' fields, and the records behind them."""

    flops: float = 0.0
    bytes_io: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    n_while: int = 0            # no loop to find: a Python loop ran its trips
    max_trip: int = 1
    ops: Dict[str, Dict[str, float]] = field(default_factory=dict)
    collectives: List[Dict[str, Any]] = field(default_factory=list)

    def table(self, n: Optional[int] = None) -> List[Dict[str, Any]]:
        """The per-op rows ``{"op", "count", "flops", "bytes"}``, most bytes first."""
        rows = [dict(op=k, **v) for k, v in self.ops.items()]
        rows.sort(key=lambda r: (-r["bytes"], -r["flops"], r["op"]))
        return rows if n is None else rows[:n]


# functional collectives (what DTensor issues) and c10d ops (what code
# calling torch.distributed issues): op name -> (kind, which side is larger)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", "in"), "all_reduce_": ("all-reduce", "in"),
    "all_reduce_coalesced": ("all-reduce", "in"), "all_reduce_coalesced_": ("all-reduce", "in"),
    "allreduce_": ("all-reduce", "in"), "allreduce_coalesced_": ("all-reduce", "in"),
    "all_gather_into_tensor": ("all-gather", "out"), "all_gather_into_tensor_out": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"), "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"), "allgather_into_tensor_coalesced_": ("all-gather", "out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"), "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "reduce_scatter_": ("reduce-scatter", "in"), "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "max"), "alltoall_base_": ("all-to-all", "max"),
    "alltoall_": ("all-to-all", "max"), "shard_dim_alltoall": ("all-to-all", "max"),
    "broadcast": ("all-gather", "in"), "broadcast_": ("all-gather", "in"),
    "send": ("collective-permute", "in"), "recv_": ("collective-permute", "in"),
}
_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_contiguous", "set_", "resize_", "empty", "empty_strided", "empty_like",
         "new_empty", "new_empty_strided", "_local_scalar_dense"}


# in-place writes of part of a tensor: the update's position in the args
# (they pay it, not the whole destination)
_UPDATE_ARG = {"copy_": 1, "scatter_": 3, "index_put_": 2, "index_copy_": 3}


def _tensors(x: Any) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(x: Any) -> float:
    return float(sum(t.numel() * t.element_size() for t in _tensors(x)))


def local_leaves(tree: Any) -> List[torch.Tensor]:
    """Each tensor leaf of ``tree`` as one device holds it: a DTensor's
    local shard, a plain tensor whole (meta and fake tensors too)."""
    return [leaf.to_local() if hasattr(leaf, "to_local") else leaf
            for _, leaf in tree_leaves_with_path(tree) if isinstance(leaf, torch.Tensor)]


def local_bytes(tree: Any) -> float:
    """Bytes one device holds of a tree (``local_leaves``)."""
    return _nbytes(local_leaves(tree))


class OpAnalysis(TorchDispatchMode):
    """Enter around a step (see the module doc); ``costs`` holds the
    result.  Nest it inside ``FakeTensorMode`` when the step runs on fake
    tensors."""

    def __init__(self):
        super().__init__()
        self.costs = OpCosts()
        self._sees_dtensor = False
        self._patches = contextlib.ExitStack()

    # ---- recording -------------------------------------------------------
    def _row(self, name: str) -> Dict[str, float]:
        prefix = "/".join(_SCOPE.get())
        key = f"{prefix}/{name}" if prefix else name
        return self.costs.ops.setdefault(key, {"count": 0, "flops": 0.0, "bytes": 0.0})

    def add_inputs(self, *trees: Any) -> None:
        """Charge the step's inputs once (one read of each local shard)."""
        self.costs.bytes_io += sum(local_bytes(t) for t in trees)

    def _collective(self, kind: str, nbytes: float, name: str, out_bytes: float) -> None:
        self.costs.collectives.append({"kind": kind, "bytes": nbytes, "op": name})
        w = collective_bytes([{"kind": kind, "bytes": nbytes}])["bytes_total"]
        self.costs.coll_bytes += w
        self.costs.coll_by_kind[kind] = self.costs.coll_by_kind.get(kind, 0.0) + w
        row = self._row(name)
        row["count"] += 1
        row["bytes"] += 2.0 * out_bytes
        self.costs.bytes_io += 2.0 * out_bytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if not self._sees_dtensor:
                raise RuntimeError("OpAnalysis: this torch lacks the DTensor internals it patches "
                                   "(ShardingPropagator._propagate_tensor_meta_non_cached, "
                                   "placement_types.shard_dim_alltoall); it can trace plain tensors only")
            return NotImplemented       # DTensor runs it as local ops, which come back here
        out = func(*args, **kwargs)
        if _QUIET.get():
            return out
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "_dtensor") and name in _COLLECTIVES:
            kind, side = _COLLECTIVES[name]
            ib, ob = _nbytes(args[:1] if ns != "c10d" else args[0]), _nbytes(out)
            size = {"in": ib, "out": ob, "max": max(ib, ob)}[side]
            self._collective(kind, size, f"{ns}.{name}", ob)
            return out
        if name in _FREE or ns == "prim" or func.is_view or not _tensors(out):
            return out
        row = self._row(name)
        row["count"] += 1
        flops = 0.0
        if func.overloadpacket in flop_registry:
            flops = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            row["flops"] += flops
            self.costs.flops += flops
        if not _tensors(args) and not flops:
            return out                  # a factory (zeros, arange): a constant in HLO, free
        upd = _UPDATE_ARG.get(name)
        nb = 2.0 * (_nbytes(args[upd]) if upd is not None and len(args) > upd else _nbytes(out))
        row["bytes"] += nb
        self.costs.bytes_io += nb
        return out

    # ---- DTensor internals it must see through -----------------------------
    @staticmethod
    @contextlib.contextmanager
    def _silenced():
        token = _QUIET.set(_QUIET.get() + 1)
        try:
            yield
        finally:
            _QUIET.reset(token)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        import torch.distributed.tensor.placement_types as placement_types

        prop = getattr(getattr(DTensor, "_op_dispatcher", None), "sharding_propagator", None)
        meta_of = getattr(prop, "_propagate_tensor_meta_non_cached", None)
        alltoall = getattr(placement_types, "shard_dim_alltoall", None)

        def quiet_meta(op_schema):
            with self._silenced():
                return meta_of(op_schema)

        def recorded_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            with self._silenced():
                out = alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
            nb = max(_nbytes(input), _nbytes(out))
            self._collective("all-to-all", nb, "_dtensor.shard_dim_alltoall", _nbytes(out))
            return out

        # DTensor internals (torch 2.13's names): a torch without them can
        # still trace plain tensors, and refuses DTensor ops (see below)
        self._sees_dtensor = meta_of is not None and alltoall is not None
        if self._sees_dtensor:
            self._patches.enter_context(_patched(prop, "_propagate_tensor_meta_non_cached", quiet_meta))
            self._patches.enter_context(_patched(placement_types, "shard_dim_alltoall", recorded_alltoall))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._patches.close()


def local_mem_tracker():
    """A ``torch.distributed._tools.mem_tracker.MemTracker`` that, like
    ``OpAnalysis``, leaves out what DTensor's sharding propagation allocates
    on global shapes (under the caller's ``FakeTensorMode`` the tracker
    cannot tell those from a rank's own).  Enter it outside an
    ``OpAnalysis``, whose patches mark the propagation."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _QUIET.get():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


@contextlib.contextmanager
def _patched(obj: Any, attr: str, value: Any) -> Iterator[None]:
    had = attr in vars(obj)
    old = vars(obj).get(attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, attr, old)
        else:
            delattr(obj, attr)


def analyze(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[Any, OpCosts]:
    """``(fn(*args, **kwargs), its OpCosts)``, the inputs charged once."""
    mode = OpAnalysis()
    mode.add_inputs(args, kwargs)
    with mode:
        out = fn(*args, **kwargs)
    return out, mode.costs
