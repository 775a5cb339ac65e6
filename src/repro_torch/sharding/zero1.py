"""ZeRO-1 optimizer-state sharding (the port of ``repro/sharding/zero1.py``):
Adam moments get the `data` axis added on their largest dimension that is
(a) not already sharded and (b) divisible, so optimizer memory scales down
by the DP degree.

On a ``DeviceMesh`` the moments placed by ``zero1_opt_shardings`` (through
``rules.distribute``) go into the port's ``adamw_update`` as DTensors with
the params and grads placed by ``param_shardings``: each rank updates its
1 / dp slice of every moment, and ``rules.distribute(new_params,
param_shardings)`` gathers the params back to their own layout.
"""
from __future__ import annotations

from typing import Any

from repro_torch.common.util import tree_map
from repro_torch.launch.mesh import MeshLike, axis_sizes
from repro_torch.sharding.rules import Sharding, Spec, sharding_for
from repro_torch.training.optim import AdamWState


def zero1_param_sharding(spec: Spec, shape, mesh: MeshLike, dp_axis: str = "data") -> Spec:
    sizes = axis_sizes(mesh)
    if dp_axis not in sizes:
        return tuple(spec)
    dp = sizes[dp_axis]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # pick the largest unsharded, divisible dim
    best, best_dim = -1, -1
    for i, (d, e) in enumerate(zip(shape, entries)):
        if e is None and d % dp == 0 and d > best:
            best, best_dim = d, i
    if best_dim >= 0:
        entries[best_dim] = dp_axis
    return tuple(entries)


def zero1_opt_shardings(opt_state: AdamWState, param_shardings: Any, mesh: MeshLike) -> AdamWState:
    """``Sharding`` tree for ``AdamWState`` given the params' sharding tree."""

    def moment(sh: Sharding, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return sharding_for((), mesh)
        return sharding_for(zero1_param_sharding(sh.spec, tuple(leaf.shape), mesh), mesh)

    return AdamWState(count=sharding_for((), mesh), m=tree_map(moment, param_shardings, opt_state.m),
                      v=tree_map(moment, param_shardings, opt_state.v))
