"""Multi-centroid associative memory (AM), port of ``repro.core.am``.

The AM is a (C, D) matrix of centroids plus a (C,) ownership vector
mapping each centroid (column of the IMC array) to its class. Two copies
coexist during training (§III-B/C): ``fp``, the float shadow AM that
iterative learning updates, and ``binary``, its 1-bit quantization
(mean threshold), which the similarity evaluation and the deployed
search use. State is a plain dict of tensors.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kernel_ref

AmState = Dict[str, torch.Tensor]


def binarize_am(fp_am: torch.Tensor, threshold: str = "mean",
                ) -> torch.Tensor:
    """1-bit quantization of the (C, D) float AM, stored bipolar: values
    strictly above the threshold -> +1, else -1. ``threshold`` is "mean"
    (global mean, the paper's choice) or "per_centroid" (row mean)."""
    if threshold == "mean":
        mu = fp_am.mean()
    elif threshold == "per_centroid":
        mu = fp_am.mean(dim=-1, keepdim=True)
    else:
        raise ValueError(f"bad threshold: {threshold!r}")
    return torch.where(fp_am > mu, 1.0, -1.0).to(fp_am.dtype)


def to_unipolar(binary_am: torch.Tensor) -> torch.Tensor:
    """{-1,+1} -> {0,1}: the bit pattern written to IMC cells."""
    return (binary_am > 0).to(torch.uint8)


def from_unipolar(bits: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """{0,1} -> {-1,+1}."""
    return bits.to(dtype) * 2.0 - 1.0


def quantize_am(fp_am, cell_bits):
    raise NotImplementedError(
        "multi-bit AM quantization is not ported yet "
        "(ROADMAP queue 1, item 10)")


def pack_am_planes(codes, cell_bits):
    raise NotImplementedError(
        "bit-plane AM packing is not ported yet (ROADMAP queue 1, item 10)")


def similarities(binary_am: torch.Tensor,
                 queries: torch.Tensor) -> torch.Tensor:
    """Dot similarity of queries (..., D) against every centroid of the
    (C, D) AM -> (..., C)."""
    return queries @ binary_am.T


def predict_from_sims(sims: torch.Tensor,
                      centroid_class: torch.Tensor) -> torch.Tensor:
    """Class owning the argmax-similarity centroid (first wins ties)."""
    return centroid_class[torch.argmax(sims, dim=-1)]


def predict(binary_am: torch.Tensor, centroid_class: torch.Tensor,
            queries: torch.Tensor) -> torch.Tensor:
    return predict_from_sims(similarities(binary_am, queries),
                             centroid_class)


def class_max_sims(sims: torch.Tensor, centroid_class: torch.Tensor,
                   n_classes: int) -> torch.Tensor:
    """Max similarity per class: (..., C) -> (..., k), a one-hot masked
    max over any ownership pattern (float32-min where a class owns no
    centroid)."""
    neg = torch.finfo(sims.dtype).min
    onehot = F.one_hot(centroid_class.long(), n_classes).bool()  # (C, k)
    masked = torch.where(onehot, sims[..., :, None],
                         torch.tensor(neg, dtype=sims.dtype,
                                      device=sims.device))
    return masked.max(dim=-2).values


def pack_am(binary_am: torch.Tensor) -> torch.Tensor:
    """(C, D) bipolar AM -> (Dp, C) uint8 packed transposed residence,
    Dp = ceil(D/8), LSB-first along D with tail bits 0 (contiguous)."""
    return kernel_ref.pack_rows(binary_am).T.contiguous()


def packed_am_bytes(dim: int, columns: int) -> int:
    """Resident bytes of the packed (Dp, C) AM: ceil(D/8) * C."""
    return (-(-dim // 8)) * columns


def packed_predict(am_packed_t: torch.Tensor, centroid_class: torch.Tensor,
                   queries: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Plain packed-domain prediction (the kernel path's reference).
    queries: (..., D) bipolar — packed here."""
    q2 = queries.reshape(-1, queries.shape[-1])
    best, _ = kernel_ref.am_search_packed(kernel_ref.pack_rows(q2),
                                          am_packed_t, n_dims)
    return centroid_class[best.long()].reshape(queries.shape[:-1])


def make_am_state(fp_am: torch.Tensor, centroid_class: torch.Tensor,
                  threshold: str = "mean") -> AmState:
    fp_am = fp_am.float()
    return {
        "fp": fp_am,
        "binary": binarize_am(fp_am, threshold),
        "centroid_class": centroid_class.to(torch.int32),
    }


def refresh_binary(state: AmState, threshold: str = "mean") -> AmState:
    return dict(state, binary=binarize_am(state["fp"], threshold))
