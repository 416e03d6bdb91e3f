"""Cost counts of one run of a function: FLOPs, HBM bytes, wire bytes.

The port's counterpart of ``repro.distributed.hlo_cost``. The reference
reads the three roofline inputs out of the optimized HLO text and has to
expand its scanned loops; the port counts one eager run of the function
(on meta tensors, which compute nothing, or on real ones):

  * flops       from ``torch.utils.flop_counter``'s registry
                (``FlopCounterMode``): matrix products and convolutions,
                as ``hlo_cost`` counts dots only;
  * hbm bytes   Σ (inputs + output) over every aten op that is not a
                view or an allocation: eager mode materializes every op,
                the counterpart of ``hlo_cost``'s "fusion boundary = HBM
                boundary" (a fusing compiler would move fewer bytes);
  * wire bytes  the ring-model bytes of the collectives the run issued
                (``distributed.collectives.record_collectives``).

Eager runs every layer, so there is no loop correction to make. The same
pass tracks the peak of the bytes the run's own op outputs hold alive
(``peak_bytes``: the counterpart of XLA's temp buffer size, without
buffer reuse or fusion).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import collectives

# Ops that move no data: aliases, metadata, allocation without a write.
_FREE = {"detach", "alias", "lift_fresh", "empty", "empty_strided",
         "empty_like", "set_", "resize_",
         "_local_scalar_dense"}


@dataclasses.dataclass
class CostTotals:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    wire_by_kind: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    n_collectives: int = 0

    def scaled(self, k: float) -> "CostTotals":
        return CostTotals(self.flops * k, self.hbm_bytes * k,
                          self.wire_bytes * k,
                          {kk: v * k for kk, v in self.wire_by_kind.items()},
                          self.peak_bytes, self.n_collectives)

    def add(self, other: "CostTotals") -> "CostTotals":
        """The sum of two counts (the peak is the larger one's)."""
        kinds = dict(self.wire_by_kind)
        for kk, v in other.wire_by_kind.items():
            kinds[kk] = kinds.get(kk, 0.0) + v
        return CostTotals(self.flops + other.flops,
                          self.hbm_bytes + other.hbm_bytes,
                          self.wire_bytes + other.wire_bytes, kinds,
                          max(self.peak_bytes, other.peak_bytes),
                          self.n_collectives + other.n_collectives)


def _tensors(values) -> list:
    """The tensors among ``values`` and one level of lists inside them
    (how aten ops take tensors)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            out.extend(x for x in v if isinstance(x, torch.Tensor))
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _ByteCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0
        self.live = 0
        self.peak = 0

    def _release(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket.__name__ in _FREE:
            return out
        ins = _tensors((*args, *kwargs.values()))
        self.total += sum(_nbytes(x) for x in ins)
        seen = {id(x) for x in ins}
        for t in _tensors(out if isinstance(out, (list, tuple)) else (out,)):
            n = _nbytes(t)
            self.total += n
            if id(t) not in seen:  # a new buffer (not an in-place result)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._release, n)
        return out


def count(fn, *args, **kwargs) -> "tuple[Any, CostTotals]":
    """(fn's result, the counts of its one run)."""
    flops = FlopCounterMode(display=False)
    with flops, _ByteCounter() as mem, \
            collectives.record_collectives() as ops:
        out = fn(*args, **kwargs)
    wire = collectives.collective_bytes(ops)
    wire.setdefault("total", 0.0)
    return out, CostTotals(flops=float(flops.get_total_flops()),
                           hbm_bytes=float(mem.total),
                           wire_bytes=wire["total"], wire_by_kind=wire,
                           peak_bytes=float(mem.peak),
                           n_collectives=len(ops))
