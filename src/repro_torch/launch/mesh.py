"""Device meshes with named axes.

Port of ``repro.launch.mesh``. The port's mesh is the one-process mesh of
the multi-device MEMHD paths (``deploy.sharded.serving_mesh``: an ordered
tuple of ``torch.device``s, repeats allowed) with names and a shape for
its axes: ``devices`` is an object array of ``torch.device`` in the
mesh's shape (row-major: member ``i`` of the flat order sits at
``np.unravel_index(i, shape)``), or ``None`` for an abstract mesh, whose
members all run on ``torch.device("meta")`` (the dry run). A collective
is a set of tensor copies the process issues between the members'
devices (``distributed.collectives``); there is no ``torch.distributed``.

Geometry of the reference's production meshes (pods of 256 chips):
  single-pod:  (16, 16)       axes ("data", "model")
  multi-pod:   (2, 16, 16)    axes ("pod", "data", "model")
"pod" is the outer data-parallel axis the int8 error-feedback gradient
ring targets; "model" carries tensor / expert / sequence sharding;
"data" data parallelism and FSDP.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.deploy.sharded import serving_mesh
from repro_torch.models.sharding import ShardingRules

META = torch.device("meta")
Axis = Union[str, Tuple[str, ...]]


class Mesh:
    """Named axes over an ordered set of devices (or an abstract shape)."""

    def __init__(self, devices: Optional[np.ndarray],
                 axis_names: Sequence[str],
                 shape: Optional[Sequence[int]] = None):
        self.axis_names = tuple(axis_names)
        if devices is not None:
            devices = np.asarray(devices, dtype=object)
            shape = devices.shape
        if shape is None or len(shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {shape} does not fit the axes "
                             f"{self.axis_names}")
        self.devices = devices
        self.dims = tuple(int(s) for s in shape)

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size} in axis order (``jax``'s ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def member_devices(self) -> List[torch.device]:
        """The members' devices in flat (row-major) order."""
        if self.devices is None:
            return [META] * self.size
        return list(self.devices.reshape(-1))

    def coords(self, member: int) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(member,
                                                          self.dims))))

    def axis_size(self, axis: Axis) -> int:
        return math.prod(self.shape[a] for a in _axes(axis))

    def axis_index(self, member: int, axis: Axis) -> int:
        """The member's index along ``axis`` (a tuple: row-major over its
        names in the given order)."""
        c = self.coords(member)
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[a] + c[a]
        return idx

    def groups(self, axis: Axis) -> List[List[int]]:
        """The members that vary along ``axis`` with every other
        coordinate fixed, one list per group, each in ``axis_index``
        order."""
        axes = _axes(axis)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no axis {a!r} in {self.axis_names}")
        out: Dict[tuple, List[Tuple[int, int]]] = {}
        for m in range(self.size):
            c = self.coords(m)
            key = tuple(c[a] for a in self.axis_names if a not in axes)
            out.setdefault(key, []).append((self.axis_index(m, axes), m))
        return [[m for _, m in sorted(g)] for g in out.values()]

    def axis_mesh(self, axis: str) -> "Mesh":
        """The 1-D mesh of the members along ``axis`` at every other
        coordinate 0."""
        group = self.groups(axis)[0]
        devs = (None if self.devices is None else
                _device_array([self.member_devices()[m] for m in group]))
        return Mesh(devs, (axis,), (len(group),))

    def __repr__(self) -> str:
        kind = "abstract" if self.devices is None else "devices"
        return f"Mesh({self.shape}, {kind})"


def _axes(axis: Axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _device_array(devices: Sequence[torch.device]) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr


def make_mesh(devices: Sequence, shape: Sequence[int],
              axes: Sequence[str]) -> Mesh:
    """A mesh over ``devices`` (flat, row-major; repeats allowed)."""
    devs = serving_mesh(devices)
    if len(devs) != math.prod(shape):
        raise ValueError(f"{len(devs)} devices for a mesh of shape "
                         f"{tuple(shape)}")
    return Mesh(_device_array(devs).reshape(tuple(shape)), axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract (the dry run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(None, axes, shape)


def make_test_mesh(shape: Tuple[int, ...] = (2, 4),
                   axes: Tuple[str, ...] = ("data", "model"),
                   devices=None) -> Mesh:
    """A small mesh whose every member runs on ``devices`` (one device
    name, or a flat sequence; default ``cuda:0`` repeated). The tests
    pass ``"cpu"``."""
    n = math.prod(shape)
    if devices is None or isinstance(devices, (str, torch.device)):
        devices = [devices or "cuda:0"] * n
    return make_mesh(devices, shape, axes)


def make_rules(mesh: Mesh, *, fsdp: bool = False, shard_seq: bool = False,
               overrides: Optional[tuple] = None) -> ShardingRules:
    return ShardingRules(mesh=mesh, fsdp=fsdp, shard_seq=shard_seq,
                         overrides=overrides)


def mesh_name(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.dims)
