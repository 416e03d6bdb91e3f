"""Step-function builders: the LM train step and serve step.

Port of ``repro.distributed.steps`` on one device. ``make_train_step``
closes over (ModelConfig, AdamWConfig, schedule) and returns
(params, opt_state, batch, step) -> (params, opt_state, metrics): the
loss and the gradient of every leaf through autograd, optional
gradient accumulation over microbatches, AdamW, and DeepSeek-V3's
aux-free router balancing (router biases move outside the gradient by
the batch's expert counts).

The reference also shards the step with logical rules under pjit and can
compress the cross-pod gradient reduce to int8 with error feedback; both
need a mesh (ROADMAP queue 1, item 17c), so ``rules`` other than None,
``grad_compression="int8_ef"`` and the dry run's ``abstract_train_state``
raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map

PyTree = Any

BIAS_UPDATE_RATE = 0.001  # DeepSeek-V3 gamma for aux-free balancing


def _apply_router_bias_update(params: PyTree, cfg: ModelConfig,
                              metrics: Dict[str, torch.Tensor]) -> PyTree:
    """Aux-free load balancing: bias += gamma * sign(mean_load - load)."""
    groups = list(params["groups"])
    for gi, (b, gp) in enumerate(zip(cfg.blocks, groups)):
        key = f"expert_counts_g{gi}"
        if b.ffn.kind != "moe" or b.ffn.router != "sigmoid" \
                or key not in metrics:
            continue
        counts = metrics[key]
        new_bias = gp["ffn"]["router_bias"] + BIAS_UPDATE_RATE * torch.sign(
            counts.mean() - counts)
        groups[gi] = dict(gp, ffn=dict(gp["ffn"], router_bias=new_bias))
    return dict(params, groups=groups)


def loss_and_grads(params: PyTree, cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *,
                   use_kernel: bool = True,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, grads) of ``T.loss_fn``: the gradient of every
    leaf (zeros where the loss does not reach a leaf, as the reference's
    ``value_and_grad`` gives), in the leaf's dtype. Loss and metrics come
    back detached."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = T.loss_fn(leaves, cfg, batch, use_kernel=use_kernel)
        got = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                       allow_unused=True))
    grads = tree_map(lambda p: _or_zeros(next(got), p), leaves)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    schedule: Callable[[Any], torch.Tensor],
                    rules=None, grad_compression: str = "none",
                    grad_accum: int = 1) -> Callable:
    """Build the train step.

    ``grad_accum`` > 1 splits the global batch into that many
    microbatches, one forward and backward each, and accumulates their
    float32 gradients / ``grad_accum``; the loss and scalar metrics are
    averaged and the expert counts summed.
    """
    if rules is not None:
        L.deferred("make_train_step(rules=...)")
    if grad_compression == "int8_ef":
        L.deferred("grad_compression='int8_ef'")
    if grad_compression != "none":
        raise ValueError(f"bad grad_compression {grad_compression!r}")

    def train_step(params, opt_state, batch, step):
        if grad_accum == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        else:
            grads, losses, metricses = None, [], []
            for i in range(grad_accum):
                mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                                   *v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, m_i, g = loss_and_grads(params, cfg, mb)
                part = tree_map(lambda gi: gi.float() / grad_accum, g)
                grads = (part if grads is None
                         else tree_map(torch.add, grads, part))
                losses.append(loss_i)
                metricses.append(m_i)
            loss = torch.stack(losses).mean()
            # Scalars average; expert counts sum over microbatches.
            metrics = {k: _reduce(k, [m[k] for m in metricses])
                       for k in metricses[0]}
            metrics["loss"] = loss
        lr_scale = schedule(step)
        new_params, new_opt = adamw_update(params, grads, opt_state,
                                           opt_cfg, lr_scale)
        new_params = _apply_router_bias_update(new_params, cfg, metrics)
        metrics = {k: v for k, v in metrics.items()
                   if not k.startswith("expert_counts")}
        metrics["grad_step"] = step + 1
        return new_params, new_opt, metrics

    return train_step


def _reduce(key: str, values: List[torch.Tensor]) -> torch.Tensor:
    stacked = torch.stack(values)
    return (stacked.sum(0) if key.startswith("expert_counts")
            else stacked.mean(0))


def make_serve_step(cfg: ModelConfig, rules=None) -> Callable:
    """One-token decode step: (params, batch, caches) -> (logits, caches)."""
    if rules is not None:
        L.deferred("make_serve_step(rules=...)")
    return lambda params, batch, caches: T.decode_step(params, cfg, batch,
                                                       caches)


def init_train_state(seed_or_generator, cfg: ModelConfig,
                     opt_cfg: AdamWConfig, *, device=None,
                     ) -> Tuple[PyTree, PyTree]:
    """(params, opt_state) on ``device`` (default the GPU), the params
    drawn from a seed or a ``torch.Generator`` on that device."""
    device = resolve_device(device)
    gen = (seed_or_generator
           if isinstance(seed_or_generator, torch.Generator)
           else generator(seed_or_generator, device))
    params = T.init_params(gen, cfg, device=device)
    return params, adamw_init(params, opt_cfg)


def abstract_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig,
                         seed: int = 0):
    """The reference's zero-allocation shapes for the dry run."""
    L.deferred("abstract_train_state (the dry run)")
