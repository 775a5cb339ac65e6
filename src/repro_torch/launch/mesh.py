"""Device meshes for sharded training (the port of ``repro/launch/mesh.py``).

A ``Mesh`` is what the sharding rules read: the axis names and their sizes
(the JAX package reads ``mesh.axis_names`` and ``mesh.devices.shape``).
It is a plain value, built without a process group, so the rules of a
256- or 512-device mesh can be computed in one process, as the JAX
package's dry run computes them over forced host devices.

    Single pod:  (data=16, model=16)            = 256 devices
    Multi-pod:   (pod=2, data=16, model=16)     = 512 devices

``device_mesh`` turns a ``Mesh`` into a ``torch.distributed`` ``DeviceMesh``
over the process group the caller has initialised (its address, world size
and rank given to ``init_process_group``), one rank per device.  The
``pod`` axis is the slowest: only data-parallel gradient reductions cross
it.

``use_mesh`` is the counterpart of ``jax.set_mesh``: the context in which
``models.moe.apply_moe_shardmap``, reached from the model's layers with no
mesh argument, finds the ``DeviceMesh`` (the JAX function reads
``jax.sharding.get_abstract_mesh()``).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple, Union

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


@dataclass(frozen=True)
class Mesh:
    """Axis names, slowest first, and their sizes."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape) or len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"mesh axes {self.axis_names} do not fit shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


MeshLike = Union[Mesh, DeviceMesh]


def axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """``{axis name: size}`` of a ``Mesh`` or a named ``DeviceMesh``."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh has no dim names: build it with device_mesh()")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> Mesh:
    """The small mesh of the multi-rank tests."""
    return Mesh(("data", "model"), (n_data, n_model))


def device_mesh(mesh: Mesh, device_type: str) -> DeviceMesh:
    """The ``DeviceMesh`` of ``mesh`` over the initialised default process
    group, rank r at the mesh coordinate of r in row-major order (the
    layout of ``jax.make_mesh`` over devices 0..n-1).  Raises unless the
    group's world size is the mesh's size."""
    if not dist.is_initialized():
        raise RuntimeError("device_mesh: no process group; call torch.distributed.init_process_group first")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"device_mesh: world size {dist.get_world_size()} != mesh size {mesh.size} "
                         f"{dict(zip(mesh.axis_names, mesh.shape))}")
    return init_device_mesh(device_type, mesh.shape, mesh_dim_names=mesh.axis_names)


_CURRENT: contextvars.ContextVar[Optional[DeviceMesh]] = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the current mesh inside the ``with`` block."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"use_mesh takes a DeviceMesh (see device_mesh), got {type(mesh).__name__}")
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    """The ``DeviceMesh`` of the innermost ``use_mesh``, or None."""
    return _CURRENT.get()
