"""One-token GQA attention over a KV cache: wrapper of the ``flash_decode``
CUDA kernel.

Port of ``repro.kernels.flash_decode`` (``csrc/flash_decode.cu``): the
decode step's attention for one query position over a length-masked
(B, S, KV, Dh) cache, online softmax (m, l, acc) in float32, query head
h reading KV head h // (H // KV), keys at index >= ``cache_len[b]``
masked, output ``acc / max(l, 1e-20)`` in q's dtype (a row with
``cache_len`` 0 yields 0). ``softcap`` caps the scaled scores at
cap * tanh(s / cap) before the running max (Gemma's logit softcap); the
kernels take it as a template flag, so ``None`` runs the uncapped
instances with the same launch plan. Each block takes one (batch row, KV head) and
one split of S for all the query heads of that KV head, so a K/V tile is
read once per group; a second pass merges the splits' partials.
bfloat16 runs on the tensor cores (``mma.sync``, K and V streamed as bf16
through a ``cp.async`` ring); float32 on a SIMT kernel in full float32.

A CPU tensor goes through the plain version (``ref.flash_decode``); a
CUDA tensor through the kernel or raises. ``flash_decode.launches``
counts kernel launches (one per call: the split pass and its merge).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, ref

MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_SMEM = 232448  # shared memory one block may opt into (H100)
SM_SMEM = 233472     # shared memory of one SM
SMEM_RESERVED = 1024  # per resident block, kept by the runtime

# float32, the SIMT kernel: tiles of 32 keys; S is split until the grid
# holds about SIMT_BLOCKS_PER_SM blocks per SM (each block waits on its
# tile loads and barriers, and more blocks overlap them).
SIMT_TILE = 32
SIMT_MIN_SPLIT = 256
SIMT_BLOCKS_PER_SM = 16
# bfloat16, the tensor-core kernel: tiles of 64 keys through a 3-stage
# ring, one block per 16 query heads of a KV head. S is split so that one
# wave of resident blocks fills the card: at Dh 64 a block holds 51.2 KB of
# shared memory, so 4 fit an SM, each with 2 tiles (32 KB) in flight:
# 128 KB per SM, well over the ~18 KB that 3.35 TB/s times ~0.7 us of HBM
# latency asks of each of 132 SMs.
MMA_TILE = 64
MMA_MIN_SPLIT = 128
MMA_STAGES = 3
MMA_QROWS = 16
MMA_MIN_BLOCKS = {32: 4, 64: 4, 128: 2, 256: 1}  # __launch_bounds__


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def head_dim_pad(dh: int) -> int:
    """The tensor-core kernel's head dim: Dh padded with zero columns."""
    return next(p for p in (32, 64, 128, 256) if dh <= p)


def smem_bytes(groups: int, dh: int, dtype: torch.dtype) -> int:
    """Shared memory of one pass-1 block (``simt_smem_bytes`` and
    ``mma_smem_bytes`` in ``csrc/flash_decode.cu``)."""
    if dtype == torch.float32:
        return 4 * (2 * groups * dh + SIMT_TILE * (dh + 1) + SIMT_TILE * dh
                    + groups * SIMT_TILE + 3 * groups)
    return 2 * head_dim_pad(dh) * (MMA_STAGES * 2 * MMA_TILE + MMA_QROWS)


def split_plan(b: int, kv: int, s: int, sms: int, *, dtype: torch.dtype,
               groups: int, dh: int) -> tuple[int, int]:
    """(n_splits, split_len): S cut into ``n_splits`` splits of
    ``split_len`` keys (a multiple of the kernel's tile); every split but
    the last is full and none is empty."""
    if dtype == torch.float32:
        tile, min_split = SIMT_TILE, SIMT_MIN_SPLIT
        want = max(1, -(-SIMT_BLOCKS_PER_SM * sms // max(1, b * kv)))
    else:
        tile, min_split = MMA_TILE, MMA_MIN_SPLIT
        per_sm = min(MMA_MIN_BLOCKS[head_dim_pad(dh)],
                     SM_SMEM // (smem_bytes(groups, dh, dtype)
                                 + SMEM_RESERVED))
        blocks = b * kv * -(-groups // MMA_QROWS)  # per split
        want = max(1, per_sm * sms // max(1, blocks))
    split_len = max(min_split, -(-s // want))
    split_len = -(-split_len // tile) * tile
    return max(1, -(-s // split_len)), split_len


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 softcap: float | None = None, return_lse: bool = False):
    """Attention of one query position over the cache.

    Args:
      q: (B, H, Dh) float32 or bfloat16.
      k_cache/v_cache: (B, S, KV, Dh), q's dtype; H % KV == 0; any S.
      cache_len: (B,) int32 valid entries per row.
      softcap: None, or a positive cap on the scaled scores.
      return_lse: also return each row's log-sum-exp of its (capped)
        scores, (B, H) float32, -inf where ``cache_len`` is 0.

    Returns: (B, H, Dh) in q's dtype, or with ``return_lse`` (out, lse):
    out unrounded in float32 (the merge pass writes float32), so that a
    sequence-parallel merge of shards rounds once, as the reference's
    psum of float32 partials does; the LSE read from the launch's
    per-split (m, l) partials (``part_ml``) as logsumexp over splits of
    m + log l, by torch ops on the same stream.
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
    if softcap is not None and not 0 < softcap < float("inf"):
        raise ValueError(f"softcap must be positive, got {softcap}")
    if q.device.type == "cpu":
        return ref.flash_decode(q, k_cache, v_cache, cache_len, softcap,
                                return_lse)
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
    out = torch.empty_like(q, dtype=torch.float32 if return_lse
                           else q.dtype)
    if out.numel() == 0 or s == 0:
        out.zero_()
        lse = torch.full((b, h), float("-inf"), device=q.device)
        return (out, lse) if return_lse else out
    groups = h // kv
    if smem_bytes(groups, dh, q.dtype) > BLOCK_SMEM:
        raise ValueError(f"flash_decode: {groups} query heads per KV head "
                         f"at head_dim {dh} do not fit shared memory")
    n_splits, split_len = split_plan(
        b, kv, s, _sm_count(q.device.index or 0), dtype=q.dtype,
        groups=groups, dh=dh)
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
            DTYPES[q.dtype], int(return_lse), float(softcap or 0.0),
            _build.stream_of(q))
    _build.check(err, "flash_decode")
    flash_decode.launches += 1
    if not return_lse:
        return out
    m, l = part_ml.unbind(-1)                      # (B, KV, splits, G)
    lse = torch.logsumexp(m + torch.log(l), dim=2)
    return out, lse.reshape(b, h)


flash_decode.launches = 0
