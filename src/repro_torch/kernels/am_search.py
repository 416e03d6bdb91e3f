"""Associative search over the unpacked ±1 AM: fp32 similarity + argmax.

Port of ``repro.kernels.am_search`` (``csrc/am_search.cu``). The kernel
computes sims = q @ am_t in true fp32 (no TF32: queries may be float H)
and keeps the first maximal column per query. ``am_t`` may be any
strided (D, C) view, so the transposed view of a resident (C, D) AM is
searched without a copy.

A CPU tensor is searched by the plain version (``ref.am_search``); a
CUDA tensor goes through the kernel or raises. ``am_search.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BN = 64  # AM columns per tile of the kernel (csrc/sims_argmax.cuh)


def am_search(q: torch.Tensor, am_t: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the multi-centroid AM.

    Args:
      q: (B, D) float32 queries.
      am_t: (D, C) float32 transposed bipolar AM (column c = centroid c),
        any strides.

    Returns:
      (best_idx, best_sim): (B,) int32 winning centroid (first wins ties)
      and (B,) float32 its dot similarity.
    """
    b, d = q.shape
    d2, c = am_t.shape
    if d != d2:
        raise ValueError(f"widths differ: {tuple(q.shape)} vs "
                         f"{tuple(am_t.shape)}")
    if c == 0:
        raise ValueError("the AM has no columns")
    if q.device != am_t.device:
        raise ValueError("q and am_t on different devices")
    if q.device.type == "cpu":
        return ref.am_search(q, am_t)
    if q.device.type != "cuda":
        raise ValueError(f"am_search: unsupported device {q.device}")
    _build.check_operand(q, "q", torch.float32, 2)
    _build.check_operand(am_t, "am_t", torch.float32, 2, contiguous=False)
    idx = torch.empty((b,), dtype=torch.int32, device=q.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q.device)
    if b == 0:
        return idx, sim
    n_ct = -(-c // BN)
    part_s = torch.empty((b, n_ct), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_ct), dtype=torch.int32, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.am_search_launch(
            q.data_ptr(), am_t.data_ptr(), am_t.stride(0), am_t.stride(1),
            part_s.data_ptr(), part_i.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, d, c, _build.stream_of(q))
    _build.check(err, "am_search")
    am_search.launches += 1
    return idx, sim


am_search.launches = 0
