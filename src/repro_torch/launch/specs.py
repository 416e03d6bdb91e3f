"""Abstract inputs and their shardings for every dry-run cell.

Port of ``repro.launch.specs``. ``input_specs(arch, shape)`` builds the
inputs a cell's step consumes as empty meta tensors (no allocation):
train cells feed {tokens, targets, ...}; decode cells a one-token batch
plus the fully grown caches (``T.init_cache`` on meta). The shardings
are spec tuples (``models.sharding``) with the reference's rank rules.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import get_config, shape_spec
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (
    NamedSharding, ShardingRules, batch_axes,
)

META = torch.device("meta")
# Cache leaves whose dim 1 is the sequence.
_SEQ_LEAVES = ("k", "v", "ckv", "krope", "k_q", "v_q", "k_s", "v_s")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _entry(axes: tuple):
    """A spec entry: one axis name alone, else the tuple (as
    ``PartitionSpec`` normalizes it)."""
    return axes[0] if len(axes) == 1 else axes


def model_config_for_cell(arch: str, shape: str) -> ModelConfig:
    cfg = get_config(arch)
    if shape_spec(shape).step == "decode":
        # Decode caches dominate memory at 32k+ contexts: the KV / latent
        # seq dim is sharded over "model" (sequence parallelism).
        cfg = dataclasses.replace(cfg, shard_seq=True)
    return cfg


def train_input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                      ) -> Dict[str, torch.Tensor]:
    b, s = global_batch, seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cfg.frontend == "audio_frames":
        specs = {"frame_embeds": _meta((b, s, cfg.d_model), bf16),
                 "targets": _meta((b, s, cfg.n_codebooks), i32)}
        if cfg.n_cond_tokens:
            specs["cond_embeds"] = _meta((b, cfg.n_cond_tokens, cfg.d_model),
                                         bf16)
        return specs
    if cfg.frontend == "vision_patches":
        s_text = s - cfg.n_patches
        return {"tokens": _meta((b, s_text), i32),
                "patch_feats": _meta((b, cfg.n_patches, T.VIT_DIM), bf16),
                "targets": _meta((b, s_text), i32)}
    return {"tokens": _meta((b, s), i32), "targets": _meta((b, s), i32)}


def decode_input_specs(cfg: ModelConfig, seq_len: int, global_batch: int,
                       ) -> Tuple[Dict[str, torch.Tensor], Any]:
    """(one-token batch, caches) on meta for a decode cell."""
    b = global_batch
    if cfg.frontend == "audio_frames":
        batch = {"frame_embeds": _meta((b, 1, cfg.d_model), torch.bfloat16)}
        if cfg.n_cond_tokens:
            batch["cond_embeds"] = _meta((b, cfg.n_cond_tokens, cfg.d_model),
                                         torch.bfloat16)
    else:
        batch = {"tokens": _meta((b, 1), torch.int32)}
    return batch, T.init_cache(cfg, b, seq_len, "bfloat16", device=META)


def input_specs(arch: str, shape: str) -> Dict[str, Any]:
    """Public entry: the abstract inputs of the (arch, shape) cell."""
    cfg = model_config_for_cell(arch, shape)
    sp = shape_spec(shape)
    if sp.step == "train":
        return {"batch": train_input_specs(cfg, sp.seq_len, sp.global_batch)}
    batch, caches = decode_input_specs(cfg, sp.seq_len, sp.global_batch)
    return {"batch": batch, "caches": caches}


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def _divisible(n: int, axes: tuple, mesh) -> bool:
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return n % size == 0


def batch_shardings(mesh, batch_specs: Dict[str, torch.Tensor],
                    ) -> Dict[str, NamedSharding]:
    """Batch dim over the data axes; everything else replicated. Batches
    smaller than the data axes (long_500k: batch 1) stay replicated."""
    ba = batch_axes(mesh)
    out = {}
    for k, v in batch_specs.items():
        lead = _entry(ba) if _divisible(v.shape[0], ba, mesh) else None
        out[k] = NamedSharding(mesh, (lead,) + (None,) * (v.dim() - 1))
    return out


def cache_shardings(mesh, caches, rules: ShardingRules):
    """Per-leaf cache shardings, by rank over the known layouts (the port's
    caches are per layer, so the reference's leading L axis is absent):
      (B, S, H, D) k/v       -> (batch, seq?, None, None)
      (B, S, R)    ckv/krope -> (batch, seq?, None)
      (B, H, N, P) ssm state -> (batch, None, None, None)
      (B, W, C)    conv      -> (batch, None, None)
      (B,)         len       -> (batch,)
    The seq dim (dim 1 of a k/v or latent leaf) is sharded over "model"
    only under ``rules.shard_seq``, where the length divides the axis and
    exceeds 1024 (ring-buffered window caches stay local)."""
    ba = batch_axes(mesh)

    def leaf(name: str, x: torch.Tensor) -> NamedSharding:
        parts: list = [None] * x.dim()
        if x.dim() >= 1 and _divisible(x.shape[0], ba, mesh):
            parts[0] = _entry(ba)
        if (name in _SEQ_LEAVES and rules.shard_seq
                and _divisible(x.shape[1], ("model",), mesh)
                and x.shape[1] > 1024):
            parts[1] = "model"
        return NamedSharding(mesh, tuple(parts))

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return leaf(name, tree)

    return walk(caches)
