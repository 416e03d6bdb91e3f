"""Logical-to-physical sharding rules (MaxText-style).

Port of ``repro.models.sharding``. Layers name their params' and
activations' dims with *logical* axes; a ``ShardingRules`` maps those to
the physical axes of a mesh (``launch.mesh.Mesh``). A spec is a tuple
with one entry per dim: ``None`` (replicated), an axis name, or a tuple
of axis names (``PartitionSpec``'s content).

The reference hands its specs to GSPMD, which places params and
activations and inserts the collectives. The port has no such compiler:
the rules decide which paths run sharded (the sequence-parallel decode,
the expert-parallel MoE, the pod gradient ring; each issues its own
collectives) and drive the dry run's per-device accounting
(``shard_shape``, ``shard_bytes``). ``shard_act`` is the identity.

Physical axes: ("pod", "data", "model") on the multi-pod mesh, ("data",
"model") single-pod; "pod" folds into the batch / FSDP axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

_state = threading.local()

Spec = Tuple[Any, ...]


def batch_axes(mesh) -> Tuple[str, ...]:
    """The axes a batch dim is cut over: ("pod", "data") on a mesh with a
    "pod" axis, else ("data",)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``'s content)."""

    mesh: Any
    spec: Spec


@dataclasses.dataclass(frozen=True, eq=False)
class ShardingRules:
    """Maps logical axis names to physical mesh axes."""

    mesh: Any
    fsdp: bool = False          # shard big param dims over the data axes
    shard_seq: bool = False     # long-context: activations' seq on model
    # Extra/overriding logical->physical entries (hillclimb knob).
    overrides: Optional[Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...]] \
        = None

    def table(self) -> Dict[Optional[str], Optional[Tuple[str, ...]]]:
        b = batch_axes(self.mesh)
        t: Dict[Optional[str], Optional[Tuple[str, ...]]] = {
            # activations
            "batch": b,
            "seq": ("model",) if self.shard_seq else None,
            "kv_seq": ("model",) if self.shard_seq else None,
            "act_embed": None,
            "act_heads": ("model",),
            "act_mlp": ("model",),
            "act_vocab": ("model",),
            "act_experts": ("model",),
            # parameters
            "vocab": ("model",),
            "embed": b if self.fsdp else None,
            "heads": ("model",),
            "kv_heads": ("model",),
            "head_dim": None,
            "mlp": ("model",),
            "experts": ("model",),
            "expert_mlp": None,
            "lora": None,
            "conv": None,
            "ssm_inner": ("model",),
            "ssm_state": None,
            None: None,
        }
        if self.overrides:
            t.update(dict(self.overrides))
        return t

    def spec(self, logical: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> Spec:
        """Resolve logical names to a spec.

        With ``shape``, mesh axes that do not divide the matching dim are
        dropped (replication: hymba's 25 heads or qwen's 40 cannot split
        16 ways; their tensor parallelism lives on the FFN instead)."""
        t = self.table()
        parts = []
        used: set = set()
        for i, name in enumerate(logical):
            ax = t.get(name)
            if ax is None:
                parts.append(None)
                continue
            ax = tuple(a for a in ax if a in self.mesh.axis_names
                       and a not in used)
            if shape is not None and ax:
                dim = shape[i]
                keep = []
                prod = 1
                for a in ax:
                    if dim % (prod * self.mesh.shape[a]) == 0:
                        keep.append(a)
                        prod *= self.mesh.shape[a]
                ax = tuple(keep)
            used.update(ax)
            parts.append(ax if len(ax) > 1 else (ax[0] if ax else None))
        return tuple(parts)

    def sharding(self, logical: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(logical, shape))


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


def shard_act(x: torch.Tensor, logical: Sequence[Optional[str]],
              ) -> torch.Tensor:
    """The reference's activation annotation: the identity here (no
    compiler places the port's activations)."""
    del logical
    return x


def _entry_size(entry, mesh) -> int:
    if entry is None:
        return 1
    names = (entry,) if isinstance(entry, str) else entry
    return math.prod(mesh.shape[a] for a in names)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One member's block of a ``shape`` laid out by ``spec`` (a dim that
    the axes do not divide rounds up, as a padded shard)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(d) // _entry_size(e, mesh))
                 for d, e in zip(shape, spec))


def shard_bytes(x, spec: Optional[Spec], mesh) -> int:
    """Bytes of one member's block of tensor ``x`` (any device, meta
    included) laid out by ``spec`` (None: replicated)."""
    shape = tuple(x.shape)
    if spec is not None:
        shape = shard_shape(shape, spec, mesh)
    return math.prod(shape) * x.element_size()


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple)


def _map(fn, tree, *rest):
    if _is_axes_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    raise TypeError(f"not an axes tree node: {type(tree).__name__}")


def param_sharding_tree(axes_tree, rules: Optional[ShardingRules],
                        params_tree=None):
    """A tree of logical-axis tuples mapped to ``NamedSharding``s (or
    ``None`` without rules). ``params_tree`` (tensors of the same
    structure, meta ones included) enables the divisibility fallback per
    leaf."""
    if rules is None:
        return _map(lambda _: None, axes_tree)
    if params_tree is None:
        return _map(lambda ax: rules.sharding(ax), axes_tree)
    return _map(lambda ax, p: rules.sharding(ax, tuple(p.shape)),
                axes_tree, params_tree)
