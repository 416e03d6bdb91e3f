"""Collectives over the named axes of a one-process mesh, and their
inventory.

The port's counterpart of ``repro.distributed.hlo``. The reference reads
its collectives out of XLA's partitioned HLO text; the port has no HLO:
its sharded paths issue their collectives here, as copies between the
members' devices, and each call is logged on the active
``record_collectives()`` recorder. Each function takes one tensor per
mesh member (flat, row-major order, ``Mesh.member_devices()``) and
returns one per member, on that member's device; ``axis`` names one mesh
axis or a tuple of them, and the members that differ only along it form
a group.

  * ``all_reduce``: the group's tensors summed (or maxed) in group
    order on the group's first member's device, then copied to every
    member, so every member holds the same bits;
  * ``all_to_all``: ``jax.lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)``: member i of a group receives chunk i of every
    member's leading axis, concatenated in member order;
  * ``permute``: ``jax.lax.ppermute``: member ``dst`` receives member
    ``src``'s tensor for each pair of ``perm`` (indices along the axis),
    zeros where no pair names it;
  * ``account``: logs a collective a caller moves no data for (the dry
    run's).

A ``CollectiveOp`` is per member, as the reference's per-device HLO ops
are: ``result_bytes`` is one member's result, ``wire_bytes`` the bytes
one member puts on its links under the reference's ring model
(``_wire_bytes``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_state = threading.local()


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    wire_bytes: float


def _wire_bytes(kind: str, nbytes: int, g: int) -> float:
    """Per-device wire bytes of one collective under the ring models:

      all-gather(out B, group g)        : B * (g-1)/g          received
      reduce-scatter(out B, group g)    : B * (g-1)            sent+recv
      all-reduce(B, group g)            : 2 * B * (g-1)/g      (RS + AG)
      all-to-all(B, group g)            : B * (g-1)/g
      collective-permute(B)             : B
    """
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return nbytes * (g - 1) / g
    if kind == "reduce-scatter":
        return nbytes * (g - 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (g - 1) / g
    if kind == "all-to-all":
        return nbytes * (g - 1) / g
    if kind == "collective-permute":
        return float(nbytes)
    return float(nbytes)


@contextlib.contextmanager
def record_collectives():
    """Log every collective issued inside the block; yields the list."""
    prev = getattr(_state, "ops", None)
    ops: List[CollectiveOp] = []
    _state.ops = ops
    try:
        yield ops
    finally:
        _state.ops = prev
        if prev is not None:
            prev.extend(ops)


def account(kind: str, result_bytes: int, group_size: int) -> None:
    """Log one collective on the active recorder (if any)."""
    ops = getattr(_state, "ops", None)
    if ops is not None:
        ops.append(CollectiveOp(kind, int(result_bytes), int(group_size),
                                _wire_bytes(kind, int(result_bytes),
                                            int(group_size))))


def collective_bytes(ops: Sequence[CollectiveOp]) -> Dict[str, float]:
    """Summed per-device wire bytes by collective kind (+ 'total')."""
    out: Dict[str, float] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0.0) + op.wire_bytes
        out["total"] = out.get("total", 0.0) + op.wire_bytes
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _check(parts: Sequence[torch.Tensor], mesh) -> List[torch.device]:
    devs = mesh.member_devices()
    if len(parts) != len(devs):
        raise ValueError(f"{len(parts)} tensors for {len(devs)} mesh "
                         "members")
    return devs


def all_reduce(parts: Sequence[torch.Tensor], mesh, axis,
               op: str = "sum") -> List[torch.Tensor]:
    """Sum (``op="sum"``) or max (``op="max"``) over each group."""
    devs = _check(parts, mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = mesh.groups(axis)
    for group in groups:
        first = devs[group[0]]
        total = parts[group[0]].to(first)
        for m in group[1:]:
            x = parts[m].to(first)
            total = total + x if op == "sum" else torch.maximum(total, x)
        for m in group:
            out[m] = total.to(devs[m])
    account("all-reduce", _nbytes(parts[0]), len(groups[0]))
    return out


def all_to_all(parts: Sequence[torch.Tensor], mesh, axis,
               ) -> List[torch.Tensor]:
    """Each member's tensor has a leading dim of the group size; member i
    of a group receives row i of every member's, stacked in member
    order."""
    devs = _check(parts, mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = mesh.groups(axis)
    for group in groups:
        n = len(group)
        if parts[group[0]].shape[0] != n:
            raise ValueError(f"all_to_all: leading dim "
                             f"{parts[group[0]].shape[0]} != group {n}")
        for i, m in enumerate(group):
            out[m] = torch.stack([parts[j][i].to(devs[m]) for j in group])
    account("all-to-all", _nbytes(parts[0]), len(groups[0]))
    return out


def permute(parts: Sequence[torch.Tensor], mesh, axis,
            perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``ppermute`` along ``axis``: for each (src, dst) of ``perm`` (axis
    indices) the member at dst receives src's tensor."""
    devs = _check(parts, mesh)
    out: List[Optional[torch.Tensor]] = [None] * len(parts)
    groups = mesh.groups(axis)
    for group in groups:
        got = {dst: src for src, dst in perm}
        for i, m in enumerate(group):
            src = got.get(i)
            out[m] = (parts[group[src]].to(devs[m]) if src is not None
                      else torch.zeros_like(parts[m]))
    account("collective-permute", _nbytes(parts[0]), len(groups[0]))
    return out
