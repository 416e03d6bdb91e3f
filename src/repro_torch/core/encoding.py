"""Hypervector encoding modules (EM), port of ``repro.core.encoding``.

``projection`` — H = M^T F with a bipolar (+-1) random projection matrix
M of shape (f, D): a plain MVM, so it maps onto IMC arrays.
``id_level`` — H = sum_i ID_i * L_{x_i} with random bipolar ID vectors
and thermometer-correlated level vectors: the encoder of the SearcHD /
QuantHD / LeHDC baselines (Table I). Every term is ±1 and |H| <= f, so
its float32 sums are exact in any order: the port equals the reference
bit for bit at any chunking.

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


# -- ID-Level encoding -------------------------------------------------------

# Bytes of the (rows, chunk, D) gather buffer of one step of
# ``encode_id_level``: the rows of a step are cut to keep it below this.
GATHER_BYTES = 1 << 28


def _rademacher(gen: torch.Generator, shape) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=gen, device=gen.device)
    return bits.float() * 2.0 - 1.0


def _level_vectors(gen: torch.Generator, levels: int,
                   dim: int) -> torch.Tensor:
    """Thermometer-correlated level hypervectors, (levels, dim).

    L_0 is random bipolar; level i flips the first
    floor(i * (dim // 2) / (levels - 1)) positions of a random flip
    order, so the flips are nested, L_0 and L_{levels-1} differ at
    dim // 2 positions, and intermediate levels interpolate.
    """
    base = _rademacher(gen, (dim,))
    perm = torch.randperm(dim, generator=gen, device=gen.device)
    rank = torch.empty_like(perm)
    rank[perm] = torch.arange(dim, device=perm.device)
    n_flips = (torch.arange(levels, device=perm.device) * (dim // 2)
               ) // max(levels - 1, 1)
    flip = rank[None, :] < n_flips[:, None]
    return torch.where(flip, -base[None, :], base[None, :])


def init_id_level(gen: torch.Generator, cfg: EncoderConfig,
                  ) -> EncoderParams:
    """Bipolar ID vectors (f, D) and level vectors (L, D), on the
    generator's device."""
    ids = _rademacher(gen, (cfg.features, cfg.dim))
    return {"ids": ids, "levels": _level_vectors(gen, cfg.levels, cfg.dim)}


def quantize_features(feats: torch.Tensor, levels: int) -> torch.Tensor:
    """Map features (assumed in [0, 1]) to integer level indices: float32
    clip, scale and round half to even, as the reference."""
    q = feats.float().clamp(0.0, 1.0) * (levels - 1)
    return torch.round(q).long()


def encode_id_level(params: EncoderParams, feats: torch.Tensor,
                    *, chunk: int = 128) -> torch.Tensor:
    """H = sum_i ID_i * L_{x_i}: (..., f) -> (..., D).

    Features go ``chunk`` at a time and rows as many as keep the
    (rows, chunk, D) gather under ``GATHER_BYTES``. The reference's
    padded feature columns add zero, so leaving them out changes no bit.
    """
    ids, lvls = params["ids"], params["levels"]
    f, d = ids.shape
    x = quantize_features(feats, lvls.shape[0])
    batch_shape = x.shape[:-1]
    x2 = x.reshape(-1, f)
    out = torch.zeros((x2.shape[0], d), dtype=torch.float32,
                      device=ids.device)
    rows = max(1, GATHER_BYTES // (4 * min(chunk, f) * d))
    for r0 in range(0, x2.shape[0], rows):
        xr = x2[r0:r0 + rows]
        acc = out[r0:r0 + rows]
        for c0 in range(0, f, chunk):
            lv = lvls[xr[:, c0:c0 + chunk]]  # (rows, chunk, D)
            acc += lv.mul_(ids[c0:c0 + chunk]).sum(dim=1)
    return out.reshape(*batch_shape, d)


# -- unified interface -------------------------------------------------------

def init_encoder(gen: torch.Generator, cfg: EncoderConfig) -> EncoderParams:
    if cfg.kind == "projection":
        return init_projection(gen, cfg)
    return init_id_level(gen, cfg)


def encode(params: EncoderParams, cfg: EncoderConfig,
           feats: torch.Tensor) -> torch.Tensor:
    """Encode features into (float) hypervectors H."""
    if cfg.kind == "projection":
        return encode_projection(params, feats)
    return encode_id_level(params, feats)


def binarize_query(h: torch.Tensor) -> torch.Tensor:
    """Bipolar binarization sign(H) in {-1, +1}, with sign(0) -> +1."""
    return torch.where(h >= 0, 1.0, -1.0).to(h.dtype)


def encode_query(params: EncoderParams, cfg: EncoderConfig,
                 feats: torch.Tensor) -> torch.Tensor:
    """Encode + (optionally) binarize — the inference-path encoder."""
    h = encode(params, cfg, feats)
    return binarize_query(h) if cfg.binarize_query else h
