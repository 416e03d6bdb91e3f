"""Hypervector encoding modules (EM), port of ``repro.core.encoding``.

``projection`` — H = M^T F with a bipolar (+-1) random projection matrix
M of shape (f, D): a plain MVM, so it maps onto IMC arrays. The
``id_level`` encoder of the Table-I baselines is not ported yet
(ROADMAP queue 1, item 3).

Encoders are parameterised by plain dicts of tensors created with
``init_*`` functions; randomness comes from an explicit
``torch.Generator`` (its stream differs from ``jax.random``'s, so parity
tests hand the reference's projection across as an array).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.types import EncoderConfig

EncoderParams = Dict[str, torch.Tensor]


def init_projection(gen: torch.Generator, cfg: EncoderConfig,
                    ) -> EncoderParams:
    """Bipolar random projection M: (f, D) in {-1, +1} (Rademacher), on
    the generator's device."""
    bits = torch.randint(0, 2, (cfg.features, cfg.dim), generator=gen,
                         device=gen.device)
    return {"projection": bits.float() * 2.0 - 1.0}


def encode_projection(params: EncoderParams,
                      feats: torch.Tensor) -> torch.Tensor:
    """H = M^T F, batched: (..., f) -> (..., D), float32 accumulation."""
    return feats.float() @ params["projection"]


def init_encoder(gen: torch.Generator, cfg: EncoderConfig) -> EncoderParams:
    if cfg.kind == "projection":
        return init_projection(gen, cfg)
    raise NotImplementedError(
        "id_level encoding is not ported yet (ROADMAP queue 1, item 3)")


def encode(params: EncoderParams, cfg: EncoderConfig,
           feats: torch.Tensor) -> torch.Tensor:
    """Encode features into (float) hypervectors H."""
    if cfg.kind == "projection":
        return encode_projection(params, feats)
    raise NotImplementedError(
        "id_level encoding is not ported yet (ROADMAP queue 1, item 3)")


def binarize_query(h: torch.Tensor) -> torch.Tensor:
    """Bipolar binarization sign(H) in {-1, +1}, with sign(0) -> +1."""
    return torch.where(h >= 0, 1.0, -1.0).to(h.dtype)


def encode_query(params: EncoderParams, cfg: EncoderConfig,
                 feats: torch.Tensor) -> torch.Tensor:
    """Encode + (optionally) binarize — the inference-path encoder."""
    h = encode(params, cfg, feats)
    return binarize_query(h) if cfg.binarize_query else h
