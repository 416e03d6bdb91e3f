"""Step-function builders: the LM train step and serve step.

Port of ``repro.distributed.steps``. ``make_train_step`` closes over
(ModelConfig, AdamWConfig, schedule, ShardingRules) and returns
(params, opt_state, batch, step) -> (params, opt_state, metrics): the
loss and the gradient of every leaf through autograd, optional
gradient accumulation over microbatches, AdamW, and DeepSeek-V3's
aux-free router balancing (router biases move outside the gradient by
the batch's expert counts).

With ``rules`` the step runs under ``use_rules(rules)``: the MoE takes
its expert-parallel path over the rules' mesh, and nothing else changes
numerically (the reference's GSPMD placement has no counterpart: see
``models.sharding``). With ``grad_compression="int8_ef"`` and a "pod"
axis of n members, the batch is cut into n contiguous shards, each
member computes its forward and backward on its device (the params
replicated once per distinct device), and the gradients cross the pods
through ``_compress_pod_grads``: int8 error-feedback quantization with
the member's own residual buffer, the int8 ring reduce-scatter, the
float32 ring all-gather, / n. AdamW then runs on the first device. The
reference names this step but never wires it to a runnable function.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import generator, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import ShardingRules, use_rules
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compression import (
    ef_int8_compress, ring_all_gather, ring_reduce_scatter_int8,
)

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


def _local_grads(params: PyTree, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor], grad_accum: int,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """(loss, metrics, grads) of one batch, over ``grad_accum``
    microbatches: their float32 gradients / ``grad_accum`` accumulated,
    the loss and scalar metrics averaged and the expert counts summed."""
    if grad_accum == 1:
        return loss_and_grads(params, cfg, batch)
    grads, losses, metricses = None, [], []
    for i in range(grad_accum):
        mb = {k: v.reshape(grad_accum, v.shape[0] // grad_accum,
                           *v.shape[1:])[i]
              for k, v in batch.items()}
        loss_i, m_i, g = loss_and_grads(params, cfg, mb)
        part = tree_map(lambda gi: gi.float() / grad_accum, g)
        grads = part if grads is None else tree_map(torch.add, grads, part)
        losses.append(loss_i)
        metricses.append(m_i)
    loss = torch.stack(losses).mean()
    metrics = {k: _reduce(k, [m[k] for m in metricses])
               for k in metricses[0]}
    metrics["loss"] = loss
    return loss, metrics, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    schedule: Callable[[Any], torch.Tensor],
                    rules: Optional[ShardingRules] = None,
                    grad_compression: str = "none",
                    grad_accum: int = 1) -> Callable:
    """Build the train step.

    ``grad_accum`` > 1 splits the (member's) batch into that many
    microbatches, one forward and backward each. With
    ``grad_compression="int8_ef"`` the rules' mesh must have a "pod"
    axis and ``opt_state`` an "ef_err" entry (``init_ef_buffers``); the
    step returns the members' new residuals there.
    """
    if grad_compression not in ("none", "int8_ef"):
        raise ValueError(f"bad grad_compression {grad_compression!r}")
    pod = grad_compression == "int8_ef"
    if pod and (rules is None or "pod" not in rules.mesh.axis_names):
        raise ValueError("grad_compression='int8_ef' needs rules whose "
                         "mesh has a 'pod' axis")
    pod_mesh = rules.mesh.axis_mesh("pod") if pod else None

    def train_step(params, opt_state, batch, step):
        with use_rules(rules):
            if pod:
                loss, metrics, grads, opt_state = _pod_grads(
                    params, cfg, batch, opt_state, pod_mesh, grad_accum)
            else:
                loss, metrics, grads = _local_grads(params, cfg, batch,
                                                    grad_accum)
            lr_scale = schedule(step)
            new_params, new_opt = adamw_update(params, grads, opt_state,
                                               opt_cfg, lr_scale)
            if pod:
                new_opt["ef_err"] = opt_state["ef_err"]
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


def _pod_grads(params: PyTree, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor], opt_state: PyTree, mesh,
               grad_accum: int):
    """Each pod member's gradient of its contiguous batch shard on its
    device, reduced by ``_compress_pod_grads``. Returns (loss, metrics,
    member 0's reduced grads, opt_state with the new residuals); the loss
    and scalar metrics are the members' mean, the expert counts their
    sum."""
    devs = mesh.member_devices()
    n = len(devs)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} pod shards")
    rows = b // n
    reps = {d: params if d == tree_leaves(params)[0].device
            else tree_map(lambda p: p.to(d), params) for d in set(devs)}
    first = devs[0]
    losses, metricses, grads = [], [], []
    for j, dev in enumerate(devs):
        shard = {k: v[j * rows:(j + 1) * rows].to(dev)
                 for k, v in batch.items()}
        with use_rules(None):
            loss, metrics, g = _local_grads(reps[dev], cfg, shard,
                                            grad_accum)
        losses.append(loss.to(first))
        metricses.append({k: v.to(first) for k, v in metrics.items()})
        grads.append(g)
    reduced, ef = _compress_pod_grads(grads, opt_state["ef_err"], mesh)
    metrics = {k: _reduce(k, [m[k] for m in metricses])
               for k in metricses[0]}
    loss = torch.stack(losses).mean()
    metrics["loss"] = loss
    return loss, metrics, reduced[0], dict(opt_state, ef_err=ef)


def _compress_pod_grads(grads: List[PyTree], ef_err: List[PyTree], mesh,
                        ) -> Tuple[List[PyTree], List[PyTree]]:
    """Int8 error-feedback all-reduce of the pod members' gradients (ref
    ``_compress_pod_grads``).

    grads[j], ef_err[j]: member j's gradient tree and float32 residual
    tree, on its device; ``mesh`` the 1-D "pod" mesh. Per leaf: each
    member quantizes g + err (``ef_int8_compress``), its blocks (padded to
    a multiple of n rows) go through ``ring_reduce_scatter_int8`` and
    ``ring_all_gather``, and the sum / n is the leaf's reduced gradient
    in the leaf's dtype, bit-identical on every member. Returns (reduced
    grads per member, new residuals per member).
    """
    n = mesh.size
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in ef_err]
    out_g: List[List[torch.Tensor]] = [[] for _ in range(n)]
    out_e: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for i in range(len(flat_g[0])):
        deq = []
        for j in range(n):
            g = flat_g[j][i]
            q, scale, new_err = ef_int8_compress(g, flat_e[j][i])
            d = q.float() * scale
            deq.append(torch.nn.functional.pad(d, (0, 0, 0, -d.shape[0] % n)))
            out_e[j].append(new_err)
        red = ring_reduce_scatter_int8(deq, mesh, "pod")
        full = ring_all_gather(red, mesh, "pod")
        for j in range(n):
            g = flat_g[j][i]
            out_g[j].append((full[j].reshape(-1)[:g.numel()] / n)
                            .reshape(g.shape).to(g.dtype))
    return ([_rebuild(grads[j], iter(out_g[j])) for j in range(n)],
            [_rebuild(ef_err[j], iter(out_e[j])) for j in range(n)])


def _rebuild(like: PyTree, it) -> PyTree:
    return tree_map(lambda _: next(it), like)


def init_ef_buffers(params: PyTree, n_members: int = 1,
                    devices=None) -> List[PyTree]:
    """One float32 zero residual tree per pod member (the shard-local
    buffer inside the reference's ``shard_map``), on ``devices[j]`` (a
    sequence, e.g. the "pod" mesh's ``member_devices()``; default each
    leaf's device)."""
    devs = list(devices) if devices is not None else [None] * n_members
    return [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=d or p.device), params)
            for d in devs[:n_members]]


def make_serve_step(cfg: ModelConfig,
                    rules: Optional[ShardingRules] = None) -> Callable:
    """One-token decode step: (params, batch, caches) -> (logits, caches),
    under ``use_rules(rules)`` (with ``cfg.seq_parallel_decode`` and
    ``rules.shard_seq`` the GQA caches go sequence-parallel)."""

    def serve_step(params, batch, caches):
        with use_rules(rules):
            return T.decode_step(params, cfg, batch, caches)

    return serve_step


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
                         seed: int = 0) -> Tuple[PyTree, PyTree, PyTree]:
    """(params, opt_state, logical axes) for the dry run: params and
    AdamW state as empty meta tensors with the reference's shapes and
    dtypes (``layers.abstract_init``: nothing allocated or drawn), and
    ``T.param_axes(cfg)``. ``seed`` is the reference's and unused."""
    del seed
    with L.abstract_init():
        params = T.init_params(None, cfg)
    return params, adamw_init(params, opt_cfg), T.param_axes(cfg)
