"""Plain PyTorch versions of the port's serving kernels.

These are the *semantics* of the CUDA kernels in ``csrc/``, written as
ordinary tensor code: the wrappers use them for CPU tensors, the tests
hold them against the JAX package's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card. Keep them boring and
obviously correct.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def binary_mvm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = x @ w in float32. x: (B, K); w: (K, N) bipolar."""
    return x.float() @ w.float()


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack (R, C) values, C % 8 == 0, into (R, C // 8) uint8, 8 cells
    per byte, LSB-first; a cell is "1" iff x > 0."""
    r, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    bits = (x > 0).to(torch.int32).reshape(r, c // 8, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=x.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bits: (R, C//8) uint8 -> (R, C) float32 {-1, +1}."""
    r, cb = packed.shape
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(r, cb * 8).float() * 2 - 1


def pack_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, D) bipolar -> (B, ceil(D/8)) uint8; tail bits packed as 0
    (the tail is padded with -1, which packs as bit 0)."""
    pad = -x.shape[-1] % 8
    x = x.float()
    if pad:
        x = F.pad(x, (0, pad), value=-1.0)
    return pack_bits(x)


def hamming_distances(q_packed: torch.Tensor,
                      am_packed_t: torch.Tensor) -> torch.Tensor:
    """popcount(XOR) distances: (B, Dp) u8, (Dp, C) u8 -> (B, C) int32."""
    x = torch.bitwise_xor(q_packed.to(torch.int32)[:, :, None],
                          am_packed_t.to(torch.int32)[None, :, :])
    v = x - ((x >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    pc = (v + (v >> 4)) & 0x0F
    return pc.sum(dim=1, dtype=torch.int32)


def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor,
                     n_dims: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-domain associative search: (best_idx int32, best_sim f32),
    sim = n_dims - 2 * hamming, first-wins on ties (``torch.max`` over a
    dim returns the first maximal index)."""
    sims = (n_dims - 2 * hamming_distances(q_packed, am_packed_t)).float()
    best_sim, best_idx = sims.max(dim=-1)
    return best_idx.to(torch.int32), best_sim


def encode_pack(feats: torch.Tensor, projection: torch.Tensor,
                ) -> torch.Tensor:
    """Feature -> packed query: H = feats @ projection in float32, bit 1
    iff H >= 0 (sign(0) -> +1), packed LSB-first along D with tail bits 0.
    (B, f), (f, D) -> (B, ceil(D/8)) uint8."""
    h = binary_mvm(feats, projection)
    return pack_rows(torch.where(h >= 0, 1.0, -1.0))


def predict_from_features(feats: torch.Tensor, projection: torch.Tensor,
                          am_packed_t: torch.Tensor,
                          centroid_class: torch.Tensor) -> torch.Tensor:
    """encode_pack + packed search + ownership gather -> (B,) classes."""
    qp = encode_pack(feats, projection)
    idx, _ = am_search_packed(qp, am_packed_t, projection.shape[1])
    return centroid_class[idx.long()]
