"""One-token GQA attention over a KV cache: wrapper of the ``flash_decode``
CUDA kernel.

Port of ``repro.kernels.flash_decode`` (``csrc/flash_decode.cu``): the
decode step's attention for one query position over a length-masked
(B, S, KV, Dh) cache, online softmax (m, l, acc) in float32, query head
h reading KV head h // (H // KV), keys at index >= ``cache_len[b]``
masked, output ``acc / max(l, 1e-20)`` in q's dtype (a row with
``cache_len`` 0 yields 0). Each block takes one (batch row, KV head) and
one split of S for all the query heads of that KV head, so a K/V tile is
read once per group; a second pass merges the splits' partials.

A CPU tensor goes through the plain version (``ref.flash_decode``); a
CUDA tensor through the kernel or raises. ``flash_decode.launches``
counts kernel launches (one per call: the split pass and its merge).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

TILE = 32          # keys per shared-memory tile: one per lane of a warp
MIN_SPLIT = 256    # fewest keys one block streams
BLOCKS_PER_SM = 16  # split S until the grid holds this many blocks per SM
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(b: int, kv: int, s: int, sms: int) -> tuple[int, int]:
    """(n_splits, split_len): S cut into splits of ``split_len`` keys (a
    TILE multiple, at least MIN_SPLIT) so that B * KV * n_splits blocks
    give every SM about BLOCKS_PER_SM blocks."""
    want = max(1, -(-BLOCKS_PER_SM * sms // max(1, b * kv)))
    split_len = max(MIN_SPLIT, -(-s // want))
    split_len = -(-split_len // TILE) * TILE
    return max(1, -(-s // split_len)), split_len


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor,
                 ) -> torch.Tensor:
    """Attention of one query position over the cache.

    Args:
      q: (B, H, Dh) float32 or bfloat16.
      k_cache/v_cache: (B, S, KV, Dh), q's dtype; H % KV == 0; any S.
      cache_len: (B,) int32 valid entries per row.

    Returns: (B, H, Dh) in q's dtype.
    """
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != dh or h % kv:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not fit "
                         f"the cache {tuple(k_cache.shape)}")
    if tuple(cache_len.shape) != (b,):
        raise ValueError(f"cache_len: expected ({b},), got "
                         f"{tuple(cache_len.shape)}")
    if len({q.device, k_cache.device, v_cache.device,
            cache_len.device}) != 1:
        raise ValueError("flash_decode: operands on different devices")
    if q.device.type == "cpu":
        return ref.flash_decode(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    _build.check_operand(q, "q", q.dtype, 3)
    _build.check_operand(k_cache, "k_cache", q.dtype, 4)
    _build.check_operand(v_cache, "v_cache", q.dtype, 4)
    _build.check_operand(cache_len, "cache_len", torch.int32, 1)
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if s == 0:
        return out.zero_()
    groups = h // kv
    n_splits, split_len = split_plan(b, kv, s, _sm_count(q.device.index
                                                         or 0))
    part_ml = torch.empty((b, kv, n_splits, groups, 2), dtype=torch.float32,
                          device=q.device)
    part_acc = torch.empty((b, kv, n_splits, groups, dh),
                           dtype=torch.float32, device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.flash_decode_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), part_ml.data_ptr(), part_acc.data_ptr(),
            out.data_ptr(), b, s, h, kv, dh, n_splits, split_len,
            DTYPES[q.dtype], _build.stream_of(q))
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
