"""Plain PyTorch versions of the port's kernels.

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


def am_search(q: torch.Tensor, am_t: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search: q (B, D) @ am_t (D, C) in float32, then
    (best_idx int32, best_sim f32), first-wins on ties."""
    sims = q.float() @ am_t.float()
    best_sim, best_idx = sims.max(dim=-1)
    return best_idx.to(torch.int32), best_sim


def unpack_rows(packed: torch.Tensor, n_dims: int) -> torch.Tensor:
    """(R, Dp) uint8 -> (R, Dp*8) float32: +1 / -1 for dims < n_dims and
    0 beyond, so a dot over the unpacked rows equals the bipolar dot over
    the first n_dims dims."""
    x = unpack_bits(packed)
    valid = torch.arange(x.shape[1], device=x.device) < n_dims
    return torch.where(valid, x, 0.0)


def am_search_packed_unpack(q_packed: torch.Tensor,
                            am_packed_t: torch.Tensor, n_dims: int,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mode="unpack"``: both packed operands unpacked to ±1 (0 past
    n_dims) and searched by the float dot — the same (idx, sim) as the
    popcount mode."""
    return am_search(unpack_rows(q_packed, n_dims),
                     unpack_rows(am_packed_t.T, n_dims).T)


def qail_targets(q: torch.Tensor, am_t: torch.Tensor,
                 centroid_class: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QAIL steps 1-2 for one minibatch: (pred_t, true_t, mis).

    pred_t: Eq. (4), the global first-wins argmax of q @ am_t; true_t:
    Eq. (5), the argmax with every centroid the label does not own masked
    to float32-min (0 when the label owns none); mis: (B,) float32, 1
    where the predicted centroid's class is not the label, times mask.
    """
    sims = q.float() @ am_t.float()  # (B, C)
    pred_t = torch.argmax(sims, dim=-1)
    mis = (centroid_class[pred_t] != labels).float() * mask
    neg = torch.tensor(torch.finfo(sims.dtype).min, device=sims.device)
    own = centroid_class[None, :] == labels[:, None]
    true_t = torch.argmax(torch.where(own, sims, neg), dim=-1)
    return pred_t, true_t, mis


def qail_update_delta(q: torch.Tensor, upd: torch.Tensor,
                      am_t: torch.Tensor, centroid_class: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor, lr: float,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused QAIL inner step (§III-C steps 1-3) for one minibatch.

    q, upd: (B, D); am_t: (D, C) transposed binary AM; centroid_class:
    (C,); labels: (B,) (-1 for padded rows); mask: (B,) {0, 1}. Returns
    (delta (C, D) float32, n_miss float32 scalar) with delta = W^T @ upd,
    W[i] = lr*mis_i*(onehot(true_t_i) - onehot(pred_t_i)).
    """
    pred_t, true_t, mis = qail_targets(q, am_t, centroid_class, labels,
                                       mask)
    return qail_delta(upd, pred_t, true_t, mis, lr, am_t.shape[1])


def qail_delta(upd: torch.Tensor, pred_t: torch.Tensor,
               true_t: torch.Tensor, mis: torch.Tensor, lr: float, c: int,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """QAIL step 3 from the targets: (W^T @ upd, mis.sum())."""
    w = (lr * mis)[:, None] * (F.one_hot(true_t.long(), c).float()
                               - F.one_hot(pred_t.long(), c).float())
    return w.T @ upd.float(), mis.sum()
