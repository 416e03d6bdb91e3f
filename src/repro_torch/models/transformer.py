"""Model assembly: embeddings -> block groups -> head(s), and the loss.

Port of ``repro.models.transformer`` for all ten registered
architectures: token-id models and the two modality
frontends (``audio_frames``: precomputed frame embeddings, cross-attended
conditioning and codebook heads; ``vision_patches``: projected patch
features ahead of the text), with GQA, MLA, Mamba-2 SSD or hybrid
mixers, dense or MoE FFNs, and the int8 KV cache. Parameters are nested
dicts of tensors; a group's layers are stacked along a leading ``repeat``
axis as in the reference, so the reference's params cross one to one
(``convert.lm_params_from_numpy``). Layers run in a Python loop over
that axis (``unbind``: one view per layer, whose gradients autograd
stacks back in one pass). With ``cfg.remat`` and grad mode on, each
layer runs under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of its scan body): the backward recomputes the
layer's activations instead of keeping them; the numbers are the same.

Public surface:
  init_params(generator, cfg, device=)       -> params
  param_axes(cfg)                            -> logical sharding axes
  forward(params, cfg, batch)                -> logits, aux
  loss_fn(params, cfg, batch)                -> loss, metrics
  init_cache(cfg, batch, max_len, device=)   -> decode caches
  decode_step(params, cfg, batch, caches)    -> logits, caches

``use_kernel=False`` runs the kernels' plain versions. Mixed precision
runs where the reference runs it (``check_supported``): bfloat16 params
with float32 activations on every architecture (each weight product
promotes to float32, ``layers.matmul`` / ``einsum`` / ``bmm``), float32
params with bfloat16 activations on SSM-only stacks.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig

Params = Dict[str, Any]

VIT_DIM = 1024  # stub ViT feature width of the vision_patches frontend


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the reference cannot run.

    bfloat16 params with float32 activations run on every architecture,
    as in the reference: the residual stream, the caches and the logits
    are float32, and every product of an activation with a bfloat16
    weight promotes to float32. float32 params with bfloat16 activations
    run where the reference runs them: a stack of SSM blocks with no FFN
    and no cross-attention, whose residual stream stays bfloat16
    (``ssd_forward`` casts its output back). Elsewhere the reference's
    layer scan raises ``TypeError``: an attention, FFN or cross-attention
    output is float32, so the scan's carry leaves float32 where it
    entered bfloat16. The port refuses those configs here instead (a
    kept difference)."""
    if (cfg.param_dtype == cfg.activation_dtype
            or (cfg.param_dtype, cfg.activation_dtype)
            == ("bfloat16", "float32")):
        return
    if not all(b.mixer == "ssm" and not _has_ffn(b) and not b.cross_attn
               for b in cfg.blocks):
        raise NotImplementedError(
            f"{cfg.name}: float32 params with bfloat16 activations run only "
            f"on SSM blocks without an FFN or cross-attention; the "
            f"reference's layer scan raises TypeError here (its bfloat16 "
            f"carry comes back float32), so the port refuses it (a kept "
            f"difference)")


def _has_ffn(b: BlockSpec) -> bool:
    return not (b.ffn.kind == "dense" and b.ffn.d_ff == 0)


def _layer(tree, i: int):
    """Layer ``i`` of a group's stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a group's stacked tree, as views from one
    ``unbind`` a leaf (its backward stacks the layers' gradients once;
    ``tree[i]`` per layer would add a full-size gradient a layer)."""
    if isinstance(tree, dict):
        cols = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(tree.unbind(0))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _put(group, i: int, layer) -> None:
    """Copy one layer's tree into row ``i`` of the stacked group."""
    if isinstance(group, dict):
        for k in group:
            _put(group[k], i, layer[k])
    else:
        group[i].copy_(layer)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ModelConfig, b: BlockSpec,
                device) -> Params:
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    p: Params = {"ln1": L._zeros((d,), dt, device)}
    if _has_ffn(b):
        p["ln2"] = L._zeros((d,), dt, device)
    if b.mixer in ("attn", "hybrid"):
        init = L.init_gqa if b.attn.kind == "gqa" else L.init_mla
        p["attn"] = init(gen, d, b.attn, dt, device)
    if b.mixer in ("ssm", "hybrid"):
        p["ssm"] = L.init_ssm(gen, d, b.ssm, dt, device)
    if b.cross_attn:
        p["ln_x"] = L._zeros((d,), dt, device)
        p["xattn"] = L.init_cross_attn(gen, d, b.attn, dt, device)
    if b.ffn.kind == "moe":
        p["ffn"] = L.init_moe_ffn(gen, d, b.ffn, dt, device)
    elif _has_ffn(b):
        p["ffn"] = L.init_dense_ffn(gen, d, b.ffn, dt, device)
    return p


def _init_group(gen: torch.Generator, cfg: ModelConfig, b: BlockSpec,
                device) -> Params:
    """A group's params stacked along ``repeat``, drawn layer by layer
    into the stacked tensors: one layer's draw is the only transient."""
    first = _init_layer(gen, cfg, b, device)
    group = _map(lambda t: t.new_empty((b.repeat, *t.shape)), first)
    _put(group, 0, first)
    del first
    for i in range(1, b.repeat):
        _put(group, i, _init_layer(gen, cfg, b, device))
    return group


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Params:
    """Random params with the reference's shapes, dtypes and
    distributions, drawn from ``generator`` (which must live on
    ``device``; default the GPU). The draws are not ``jax.random``'s. A
    large leaf is drawn in float32 slices (``layers.normal``), so a
    bfloat16 model never has a float32 copy resident. Under
    ``layers.abstract_init()`` every leaf is an empty meta tensor and
    nothing is drawn (``generator`` may be None)."""
    device = L.META if L.is_abstract() else resolve_device(device)
    check_supported(cfg)
    dt = _dtype(cfg.param_dtype)
    d = cfg.d_model
    emb_std = 1.0 / math.sqrt(d)
    shape = (cfg.padded_vocab, d)
    p: Params = {"embed": L.normal(generator, shape, emb_std, dt, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = L.normal(generator, shape, emb_std, dt, device)
    if cfg.n_codebooks > 1:
        p["codebook_heads"] = L.normal(
            generator, (cfg.n_codebooks - 1, *shape), emb_std, dt, device)
    if cfg.frontend == "vision_patches":
        p["patch_proj"] = L._dense_init(generator, (VIT_DIM, d), dt, device)
    p["groups"] = [_init_group(generator, cfg, b, device)
                   for b in cfg.blocks]
    p["ln_f"] = L._zeros((d,), dt, device)
    if cfg.mtp_depth:
        p["mtp"] = {"block": _init_layer(generator, cfg, cfg.blocks[-1],
                                         device),
                    "proj": L._dense_init(generator, (2 * d, d), dt,
                                          device),
                    "ln": L._zeros((d,), dt, device)}
    return p


def _layer_axes(b: BlockSpec) -> Params:
    a: Params = {"ln1": ("embed",)}
    if _has_ffn(b):
        a["ln2"] = ("embed",)
    if b.mixer in ("attn", "hybrid"):
        a["attn"] = (L.gqa_axes(b.attn) if b.attn.kind == "gqa"
                     else L.mla_axes(b.attn))
    if b.mixer in ("ssm", "hybrid"):
        a["ssm"] = L.ssm_axes()
    if b.cross_attn:
        a["ln_x"] = ("embed",)
        a["xattn"] = L.cross_attn_axes()
    if b.ffn.kind == "moe":
        a["ffn"] = L.moe_ffn_axes(b.ffn)
    elif _has_ffn(b):
        a["ffn"] = L.dense_ffn_axes(b.ffn)
    return a


def param_axes(cfg: ModelConfig) -> Params:
    """The params' logical sharding axes, the reference's second return
    value of ``init_params``: the same tree with a tuple of logical axis
    names per dim at each leaf (a group's leaves lead with ``None``, its
    stacking axis). Allocates nothing."""
    a: Params = {"embed": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        a["unembed"] = ("vocab", "embed")
    if cfg.n_codebooks > 1:
        a["codebook_heads"] = (None, "vocab", "embed")
    if cfg.frontend == "vision_patches":
        a["patch_proj"] = (None, "embed")
    a["groups"] = [_map(lambda ax: (None,) + ax, _layer_axes(b))
                   for b in cfg.blocks]
    a["ln_f"] = ("embed",)
    if cfg.mtp_depth:
        a["mtp"] = {"block": _layer_axes(cfg.blocks[-1]),
                    "proj": (None, "embed"), "ln": ("embed",)}
    return a


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mix(b: BlockSpec, lp: Params, attn, ssm) -> torch.Tensor:
    """The mixer output: attention, SSD, or hymba's mean of both."""
    mix = attn(lp["attn"]) if b.mixer in ("attn", "hybrid") else None
    if b.mixer in ("ssm", "hybrid"):
        ss = ssm(lp["ssm"])
        mix = ss if mix is None else 0.5 * (mix + ss)  # hymba fusion
    return mix


def _xattn_ffn(cfg: ModelConfig, b: BlockSpec, lp: Params,
               x: torch.Tensor, cond: Optional[torch.Tensor],
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The cross-attention and FFN residuals after the mixer's."""
    aux: Dict[str, torch.Tensor] = {}
    if b.cross_attn and cond is not None:
        hx = L.rms_norm(x, lp["ln_x"], cfg.rms_eps)
        x = x + L.cross_attn_forward(lp["xattn"], b.attn, hx, cond)
    if "ffn" in lp:
        h2 = L.rms_norm(x, lp["ln2"], cfg.rms_eps)
        if b.ffn.kind == "dense":
            y = L.dense_ffn(lp["ffn"], b.ffn, h2)
        else:
            y, aux = L.moe_ffn(lp["ffn"], b.ffn, h2)
        x = x + y
    return x, aux


def _layer_forward(cfg: ModelConfig, b: BlockSpec, lp: Params,
                   x: torch.Tensor, positions: torch.Tensor,
                   cond: Optional[torch.Tensor], use_kernel: bool,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)

    def attn(p):
        if b.attn.kind == "gqa":
            return L.gqa_forward(p, b.attn, h, positions)
        return L.mla_forward(p, b.attn, h, positions, cfg.rms_eps)

    x = x + _mix(b, lp, attn, lambda p: L.ssd_forward(
        p, b.ssm, cfg.d_model, h, use_kernel=use_kernel))
    return _xattn_ffn(cfg, b, lp, x, cond)


def _frames(cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An ``audio_frames`` batch's (frame embeddings, conditioning or
    None) in the activation dtype."""
    dt = _dtype(cfg.activation_dtype)
    cond = batch.get("cond_embeds")
    return (batch["frame_embeds"].to(dt),
            cond.to(dt) if cond is not None else None)


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Returns (hidden, positions, cond). ``audio_frames`` reads
    batch["frame_embeds"] (B, S, D) and the optional conditioning
    batch["cond_embeds"] (B, T, D); ``vision_patches`` prepends
    batch["patch_feats"] (B, P, VIT_DIM) @ patch_proj to the token
    embeddings."""
    check_supported(cfg)
    dt = _dtype(cfg.activation_dtype)
    cond = None
    if cfg.frontend == "audio_frames":
        x, cond = _frames(cfg, batch)
    else:
        x = params["embed"][batch["tokens"]].to(dt)
        if cfg.frontend == "vision_patches":
            patches = L.matmul(batch["patch_feats"].to(dt),
                               params["patch_proj"])
            x = torch.cat([patches.to(dt), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions, cond


def _head(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits, or (B, S, n_codebooks, V) with codebook heads."""
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = torch.einsum("bsd,vd->bsv", h, w.to(h.dtype))
    if cfg.n_codebooks > 1:
        extra = torch.einsum("bsd,cvd->bscv", h,
                             params["codebook_heads"].to(h.dtype))
        logits = torch.cat([logits[:, :, None, :], extra], dim=2)
    return logits


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, use_kernel: bool = True,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward over ``embed_inputs``' batch. Returns (logits
    (B, S, V) or (B, S, n_codebooks, V), aux): aux holds "final_hidden"
    (B, S, D) and, with MoE layers, "lb_loss" (summed over every softmax
    MoE layer) and "expert_counts_g{gi}" (each MoE group's per-expert
    slot counts, summed over its layers)."""
    x, positions, cond = embed_inputs(params, cfg, batch)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total: Dict[str, Any] = {}
    for gi, (b, gp) in enumerate(zip(cfg.blocks, params["groups"])):
        group_aux: Dict[str, torch.Tensor] = {}
        for lp in _unstack(gp, b.repeat):
            if remat:
                x, aux = torch.utils.checkpoint.checkpoint(
                    _layer_forward, cfg, b, lp, x, positions, cond,
                    use_kernel, use_reentrant=False)
            else:
                x, aux = _layer_forward(cfg, b, lp, x, positions, cond,
                                        use_kernel)
            for k, v in aux.items():
                group_aux[k] = group_aux[k] + v if k in group_aux else v
        for k, v in group_aux.items():
            if k == "expert_counts":
                aux_total[f"expert_counts_g{gi}"] = v
            else:
                aux_total[k] = aux_total.get(k, 0.0) + v
    h = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    aux_total["final_hidden"] = h
    return _head(params, cfg, h), aux_total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, targets: torch.Tensor,
          mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean token cross-entropy in float32 (over ``mask`` when given)."""
    logits32 = logits.float()
    logz = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, targets[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def loss_fn(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, use_kernel: bool = True,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of a training batch: next-token cross-entropy
    against batch["targets"] ((B, S), or (B, S, n_codebooks) with
    codebook heads; a vision model's loss is over the text positions
    only), plus 0.01 x the MoE load-balance loss and, with an MTP block,
    0.3 x the cross-entropy of its t+2 prediction. metrics holds
    "lm_loss", "lb_loss" and "mtp_loss" where they apply, each MoE
    group's "expert_counts_g{gi}" and "loss"."""
    logits, aux = forward(params, cfg, batch, use_kernel=use_kernel)
    h = aux.pop("final_hidden")
    if cfg.frontend == "vision_patches":
        # Text-only loss; patch positions are context.
        n_p = batch["patch_feats"].shape[1]
        loss = _xent(logits[:, n_p:], batch["targets"], None)
    else:
        loss = _xent(logits, batch["targets"], None)

    metrics = {"lm_loss": loss}
    if "lb_loss" in aux:
        lb = 0.01 * aux["lb_loss"]
        loss = loss + lb
        metrics["lb_loss"] = lb
    for k, v in aux.items():
        if k.startswith("expert_counts_g"):
            metrics[k] = v

    if cfg.mtp_depth and cfg.frontend == "none":
        # DeepSeek-V3 MTP: predict t+2 from [h_i ; emb(t_{i+1})].
        emb_next = params["embed"][batch["targets"]].to(h.dtype)
        hin = L.matmul(torch.cat([h, emb_next], dim=-1),
                       params["mtp"]["proj"])
        positions = torch.arange(h.shape[1], device=h.device)[None, :] \
            .expand(h.shape[0], -1)
        hm, _ = _layer_forward(cfg, cfg.blocks[-1], params["mtp"]["block"],
                               hin, positions, None, use_kernel)
        hm = L.rms_norm(hm, params["mtp"]["ln"], cfg.rms_eps)
        mtp_logits = _head(params, cfg, hm)[:, :-1]
        mtp = 0.3 * _xent(mtp_logits, batch["targets"][:, 1:], None)
        loss = loss + mtp
        metrics["mtp_loss"] = mtp

    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype_name: Optional[str] = None, *, device=None) -> list:
    """Decode caches on ``device`` (default the GPU; ``"meta"`` for the
    dry run's shapes): per group, a list of
    one dict per layer ({"attn": ..., "ssm": ...}). The reference stacks
    a group's caches for its scan; the port's layer loop takes them one
    by one and never copies them.

    Windowed GQA layers allocate ring buffers of min(window, S); global
    ones the full horizon, int8 with ``cfg.kv_cache_quant``; MLA layers
    the latent (ckv, krope) cache; SSM layers are O(1). With
    ``cfg.seq_parallel_decode`` under active rules, a GQA layer that the
    sequence-parallel decode takes gets its per-member blocks directly
    (``L.init_gqa_cache(seq_parallel=True)``): no whole cache is made.
    """
    device = resolve_device(device)
    check_supported(cfg)
    dt = _dtype(dtype_name or cfg.activation_dtype)
    caches = []
    for b in cfg.blocks:
        layers = []
        for _ in range(b.repeat):
            entry: Dict[str, Any] = {}
            if b.mixer in ("attn", "hybrid"):
                if b.attn.kind == "gqa":
                    entry["attn"] = L.init_gqa_cache(
                        b.attn, batch, max_len, dt, device,
                        quant=cfg.kv_cache_quant,
                        seq_parallel=cfg.seq_parallel_decode)
                else:
                    entry["attn"] = L.init_mla_cache(b.attn, batch, max_len,
                                                     dt, device)
            if b.mixer in ("ssm", "hybrid"):
                entry["ssm"] = L.init_ssm_cache(b.ssm, cfg.d_model, batch,
                                                dt, device)
            layers.append(entry)
        caches.append(layers)
    return caches


def _layer_decode(cfg: ModelConfig, b: BlockSpec, lp: Params,
                  x: torch.Tensor, cache: Dict[str, Any],
                  cond: Optional[torch.Tensor], use_kernel: bool,
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    new_cache: Dict[str, Any] = {}
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)

    def attn(p):
        if b.attn.kind == "mla":
            y, new_cache["attn"] = L.mla_decode(p, b.attn, h, cache["attn"],
                                                cfg.rms_eps)
        elif cfg.kv_cache_quant:
            y, new_cache["attn"] = L.gqa_decode_quant(p, b.attn, h,
                                                      cache["attn"])
        else:
            y, new_cache["attn"] = L.gqa_decode(
                p, b.attn, h, cache["attn"], use_kernel=use_kernel,
                seq_parallel=cfg.seq_parallel_decode)
        return y

    def ssm(p):
        y, new_cache["ssm"] = L.ssd_decode(p, b.ssm, cfg.d_model, h,
                                           cache["ssm"])
        return y

    x = x + _mix(b, lp, attn, ssm)
    x, _ = _xattn_ffn(cfg, b, lp, x, cond)
    return x, new_cache


def decode_step(params: Params, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], caches: list, *,
                use_kernel: bool = True) -> Tuple[torch.Tensor, list]:
    """One decode step for the whole stack.

    batch: {"tokens": (B, 1)}, or for ``audio_frames`` {"frame_embeds":
    (B, 1, D), "cond_embeds": (B, T, D) (optional; cross-attention K/V
    are recomputed from it every step, as in the reference)}; a vision
    model decodes text tokens. caches: ``init_cache``'s, with "len"
    advanced past any prefill. The caches are updated in place (the
    reference returns new ones) and returned. Returns (logits (B, V) or
    (B, n_codebooks, V), caches).
    """
    check_supported(cfg)
    if cfg.frontend == "audio_frames":
        x, cond = _frames(cfg, batch)
    else:
        x = params["embed"][batch["tokens"]].to(
            _dtype(cfg.activation_dtype))
        cond = None
    for b, gp, gc in zip(cfg.blocks, params["groups"], caches):
        for i in range(b.repeat):
            x, gc[i] = _layer_decode(cfg, b, _layer(gp, i), x, gc[i], cond,
                                     use_kernel)
    h = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _head(params, cfg, h)[:, 0], caches
