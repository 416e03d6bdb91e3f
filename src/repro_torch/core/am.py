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


def quantize_am(fp_am: torch.Tensor, cell_bits: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor ``cell_bits``-bit quantization of the float AM.

    Qmax = 2^(b-1) - 1 levels per sign, codes = clip(round(fp/scale),
    +-Qmax); ``codes * scale`` dequantizes, and the similarity argmax
    does not depend on the scale, so the kernels search the integer
    codes. The scale is picked by a fixed 8-step grid of fractions of
    max|fp| minimizing the quantization MSE (the QAIL shadow is
    heavy-tailed: a max-anchored scale rounds most of a 2-bit AM to 0).

    Every division is by a float32 tensor, as the reference's float32
    divisions are (a Python-number divisor would become a reciprocal
    product on CUDA). The MSE means are reductions, whose order differs
    between frameworks, so two candidates whose MSEs tie to within
    rounding may be picked differently.

    Returns (codes, scale): (C, D) int32 codes in [-Qmax, +Qmax] and the
    () float32 scale (> 0 even for an all-zero AM).
    """
    if not 2 <= cell_bits <= 8:
        raise ValueError(f"cell_bits={cell_bits} outside [2, 8]")
    qmax = 2 ** (cell_bits - 1) - 1
    fp_am = fp_am.float()
    dev = fp_am.device
    amax = torch.clamp(fp_am.abs().max(), min=torch.finfo(torch.float32).tiny)
    fracs = torch.tensor((1.0, 0.7, 0.5, 0.35, 0.25, 0.15, 0.1, 0.05),
                         dtype=torch.float32, device=dev)
    scales = fracs * amax / torch.tensor(float(qmax), device=dev)  # (K,)
    cand = torch.clamp(torch.round(fp_am[None] / scales[:, None, None]),
                       -qmax, qmax)                                # (K, C, D)
    mse = ((cand * scales[:, None, None] - fp_am[None]) ** 2).mean(
        dim=(1, 2))
    scale = scales[torch.argmin(mse)]
    codes = torch.clamp(torch.round(fp_am / scale), -qmax, qmax)
    return codes.to(torch.int32), scale


def dequantize_am(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_am``: the fake-quantized float view."""
    return codes.float() * scale


def pack_am_planes(codes: torch.Tensor, cell_bits: int) -> torch.Tensor:
    """(C, D) quantized codes -> (cell_bits, Dp, C) uint8 bit planes of
    the offset codes u = code + Qmax (``kernels.ref.pack_planes``)."""
    if not 2 <= cell_bits <= 8:
        raise ValueError(f"cell_bits={cell_bits} outside [2, 8]")
    qmax = 2 ** (cell_bits - 1) - 1
    return kernel_ref.pack_planes(codes + qmax, cell_bits)


def multibit_am_bytes(dim: int, columns: int, cell_bits: int) -> int:
    """Resident bytes of the (cell_bits, Dp, C) plane-packed AM."""
    return cell_bits * (-(-dim // 8)) * columns


def multibit_predict(am_planes_t: torch.Tensor,
                     centroid_class: torch.Tensor, queries: torch.Tensor,
                     cell_bits: int) -> torch.Tensor:
    """Plain multi-bit prediction (the kernel path's reference)."""
    q2 = queries.reshape(-1, queries.shape[-1])
    best, _ = kernel_ref.am_search_multibit(q2, am_planes_t,
                                            cell_bits=cell_bits)
    return centroid_class[best.long()].reshape(queries.shape[:-1])


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
