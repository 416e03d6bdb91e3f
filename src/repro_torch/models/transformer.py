"""Model assembly: embeddings -> block groups -> head.

Port of ``repro.models.transformer`` for token-id models (``frontend=
"none"``) whose layers are GQA attention, Mamba-2 SSD or both in
parallel (hymba), with dense FFNs. Parameters are nested dicts of
tensors; a group's layers are stacked along a leading ``repeat`` axis as
in the reference, so the reference's params cross one to one
(``convert.lm_params_from_numpy``). Layers run in a Python loop over
that axis.

Public surface:
  init_params(generator, cfg, device=)       -> params
  forward(params, cfg, batch)                -> logits, aux
  init_cache(cfg, batch, max_len, device=)   -> decode caches
  decode_step(params, cfg, batch, caches)    -> logits, caches

``use_kernel=False`` runs the kernels' plain versions. ``loss_fn`` and
the multi-token prediction head wait for the training slice.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import BlockSpec, ModelConfig

Params = Dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not have yet."""
    if cfg.frontend != "none":
        L.deferred(f"the {cfg.frontend} frontend")
    if cfg.n_codebooks > 1:
        L.deferred("codebook heads")
    if cfg.mtp_depth:
        L.deferred("multi-token prediction (MTP)")
    if cfg.kv_cache_quant:
        L.deferred("kv_cache_quant (the int8 KV cache)")
    if cfg.seq_parallel_decode:
        L.deferred("seq_parallel_decode")
    if cfg.param_dtype != cfg.activation_dtype:
        L.deferred("mixed param/activation dtypes")
    for b in cfg.blocks:
        if b.mixer in ("attn", "hybrid") and b.attn.kind == "mla":
            L.deferred("MLA attention")
        if b.ffn.kind == "moe":
            L.deferred("MoE FFN")
        if b.cross_attn:
            L.deferred("cross-attention")


def _has_ffn(b: BlockSpec) -> bool:
    return not (b.ffn.kind == "dense" and b.ffn.d_ff == 0)


def _layer(tree, i: int):
    """Layer ``i`` of a group's stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


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
        p["attn"] = L.init_gqa(gen, d, b.attn, dt, device)
    if b.mixer in ("ssm", "hybrid"):
        p["ssm"] = L.init_ssm(gen, d, b.ssm, dt, device)
    if _has_ffn(b):
        p["ffn"] = L.init_dense_ffn(gen, d, b.ffn, dt, device)
    return p


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Params:
    """Random params with the reference's shapes, dtypes and
    distributions, drawn from ``generator`` (which must live on
    ``device``; default the GPU). The draws are not ``jax.random``'s."""
    device = resolve_device(device)
    check_supported(cfg)
    dt = _dtype(cfg.param_dtype)
    emb_std = 1.0 / math.sqrt(cfg.d_model)
    shape = (cfg.padded_vocab, cfg.d_model)
    p: Params = {"embed": (torch.randn(shape, generator=generator,
                                       device=device) * emb_std).to(dt)}
    if not cfg.tie_embeddings:
        p["unembed"] = (torch.randn(shape, generator=generator,
                                    device=device) * emb_std).to(dt)
    p["groups"] = [_stack([_init_layer(generator, cfg, b, device)
                           for _ in range(b.repeat)]) for b in cfg.blocks]
    p["ln_f"] = L._zeros((cfg.d_model,), dt, device)
    return p


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer_forward(cfg: ModelConfig, b: BlockSpec, lp: Params,
                   x: torch.Tensor, positions: torch.Tensor,
                   use_kernel: bool) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    mix = None
    if b.mixer in ("attn", "hybrid"):
        mix = L.gqa_forward(lp["attn"], b.attn, h, positions)
    if b.mixer in ("ssm", "hybrid"):
        ss = L.ssd_forward(lp["ssm"], b.ssm, cfg.d_model, h,
                           use_kernel=use_kernel)
        mix = ss if mix is None else 0.5 * (mix + ss)  # hymba fusion
    x = x + mix
    if "ffn" in lp:
        x = x + L.dense_ffn(lp["ffn"], b.ffn,
                            L.rms_norm(x, lp["ln2"], cfg.rms_eps))
    return x


def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Any]]:
    """Returns (hidden, positions, cond); cond is None (no frontends)."""
    check_supported(cfg)
    x = params["embed"][batch["tokens"]].to(_dtype(cfg.activation_dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    return x, positions, None


def _head(params: Params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return torch.einsum("bsd,vd->bsv", h, w.to(h.dtype))


def forward(params: Params, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, use_kernel: bool = True,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward over batch["tokens"] (B, S). Returns
    (logits (B, S, padded vocab), {"final_hidden": (B, S, D)})."""
    x, positions, _ = embed_inputs(params, cfg, batch)
    for b, gp in zip(cfg.blocks, params["groups"]):
        for i in range(b.repeat):
            x = _layer_forward(cfg, b, _layer(gp, i), x, positions,
                               use_kernel)
    h = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _head(params, cfg, h), {"final_hidden": h}


# ---------------------------------------------------------------------------
# Decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype_name: Optional[str] = None, *, device=None) -> list:
    """Decode caches on ``device`` (default the GPU): per group, a list of
    one dict per layer ({"attn": ..., "ssm": ...}). The reference stacks
    a group's caches for its scan; the port's layer loop takes them one
    by one and never copies them.

    Windowed attention layers allocate ring buffers of min(window, S);
    global layers allocate the full horizon; SSM layers are O(1).
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
                entry["attn"] = L.init_gqa_cache(b.attn, batch, max_len, dt,
                                                 device)
            if b.mixer in ("ssm", "hybrid"):
                entry["ssm"] = L.init_ssm_cache(b.ssm, cfg.d_model, batch,
                                                dt, device)
            layers.append(entry)
        caches.append(layers)
    return caches


def _layer_decode(cfg: ModelConfig, b: BlockSpec, lp: Params,
                  x: torch.Tensor, cache: Dict[str, Any], use_kernel: bool,
                  ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    new_cache: Dict[str, Any] = {}
    h = L.rms_norm(x, lp["ln1"], cfg.rms_eps)
    mix = None
    if b.mixer in ("attn", "hybrid"):
        mix, new_cache["attn"] = L.gqa_decode(
            lp["attn"], b.attn, h, cache["attn"], use_kernel=use_kernel,
            seq_parallel=cfg.seq_parallel_decode)
    if b.mixer in ("ssm", "hybrid"):
        ss, new_cache["ssm"] = L.ssd_decode(lp["ssm"], b.ssm, cfg.d_model,
                                            h, cache["ssm"])
        mix = ss if mix is None else 0.5 * (mix + ss)
    x = x + mix
    if "ffn" in lp:
        x = x + L.dense_ffn(lp["ffn"], b.ffn,
                            L.rms_norm(x, lp["ln2"], cfg.rms_eps))
    return x, new_cache


def decode_step(params: Params, cfg: ModelConfig,
                batch: Dict[str, torch.Tensor], caches: list, *,
                use_kernel: bool = True) -> Tuple[torch.Tensor, list]:
    """One decode step for the whole stack.

    batch: {"tokens": (B, 1)}; caches: ``init_cache``'s, with "len"
    advanced past any prefill. The caches are updated in place (the
    reference returns new ones) and returned. Returns (logits (B, V),
    caches).
    """
    check_supported(cfg)
    x = params["embed"][batch["tokens"]].to(_dtype(cfg.activation_dtype))
    for b, gp, gc in zip(cfg.blocks, params["groups"], caches):
        for i in range(b.repeat):
            x, gc[i] = _layer_decode(cfg, b, _layer(gp, i), x, gc[i],
                                     use_kernel)
    h = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _head(params, cfg, h)[:, 0], caches
