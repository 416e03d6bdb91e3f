"""AdamW with optional quantized second moment.

Port of ``repro.optim.adamw``. Parameters, gradients and states are the
port's param trees: nested dicts and lists of tensors. The update is a
function that returns new trees (it does not write into its inputs).

State layout per parameter p:
  m: first moment, ``state_dtype``
  v: second moment, ``state_dtype`` or int8 block-quantized (128-blocks,
     per-block float32 scale: a ``(q, scale)`` tuple of (nblocks, 128)
     int8 and (nblocks, 1) float32; v is positive, so the codes are 0-127)
  step: 0-dim int32 tensor, the updates applied so far
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

PyTree = Any

_STATE_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
_Q_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4              # peak lr; schedules multiply on top
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    state_dtype: str = "fp32"     # "fp32" | "bf16"
    second_moment: str = "dense"  # "dense" | "int8"

    def __post_init__(self):
        if self.state_dtype not in _STATE_DTYPES:
            raise ValueError(f"bad state_dtype {self.state_dtype!r}")
        if self.second_moment not in ("dense", "int8"):
            raise ValueError(f"bad second_moment {self.second_moment!r}")

    def state_bytes_per_param(self) -> float:
        """Optimizer bytes/param."""
        m = 4 if self.state_dtype == "fp32" else 2
        v = m if self.second_moment == "dense" else 1.04  # scale overhead
        return m + v


# -- trees ----------------------------------------------------------------------

def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts (in key order) and lists; a tuple (an
    int8 ``v``) is one leaf."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# -- int8 block quantization of v ----------------------------------------------

def _q_v(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = v.reshape(-1)
    blocks = F.pad(flat, (0, -flat.shape[0] % _Q_BLOCK)).reshape(
        -1, _Q_BLOCK)
    scale = blocks.amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    # torch.round, like jnp.round, rounds half to even.
    q = torch.clamp(torch.round(blocks / scale), 0, 127).to(torch.int8)
    return q, scale.float()


def _dq_v(q: torch.Tensor, scale: torch.Tensor, shape,
          size: int) -> torch.Tensor:
    blocks = q.float() * scale
    return blocks.reshape(-1)[:size].reshape(shape)


def adamw_init(params: PyTree, cfg: AdamWConfig) -> Dict[str, PyTree]:
    """Zero moments on each leaf's device, and ``step`` 0 on the first
    leaf's."""
    dt = _STATE_DTYPES[cfg.state_dtype]
    m = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    if cfg.second_moment == "int8":
        v = tree_map(lambda p: _q_v(torch.zeros(p.shape, device=p.device)),
                     params)
    else:
        v = tree_map(lambda p: torch.zeros_like(p, dtype=dt), params)
    device = tree_leaves(params)[0].device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(leaves).sum().sqrt()


@torch.no_grad()
def adamw_update(params: PyTree, grads: PyTree, state: Dict[str, PyTree],
                 cfg: AdamWConfig, lr_scale: torch.Tensor | float = 1.0,
                 ) -> Tuple[PyTree, Dict[str, PyTree]]:
    """One AdamW step (with global-norm clipping and decoupled decay on
    every leaf). ``lr_scale`` is the schedule multiplier. Returns (new
    params, new state); the inputs are left as they were."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip_norm / (gnorm + 1e-12), 1.0)
    dt = _STATE_DTYPES[cfg.state_dtype]
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=step.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=step.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=step.device)

    def upd(p, g, m, v):
        dev = p.device
        g = g.float() * clip.to(dev)
        new_m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        if cfg.second_moment == "int8":
            v32 = _dq_v(*v, p.shape, p.numel())
        else:
            v32 = v.float()
        new_v = cfg.b2 * v32 + (1 - cfg.b2) * g.square()
        mhat = new_m / b1c.to(dev)
        vhat = new_v / b2c.to(dev)
        p32 = p.float()
        delta = mhat / (vhat.sqrt() + cfg.eps) + cfg.weight_decay * p32
        new_p = (p32 - lr.to(dev) * delta).to(p.dtype)
        new_vs = (_q_v(new_v) if cfg.second_moment == "int8"
                  else new_v.to(dt))
        return new_p, new_m.to(dt), new_vs

    outs = tree_map(upd, params, grads, state["m"], state["v"])

    def pick(i):
        return tree_map(lambda o: o[i], outs)

    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
