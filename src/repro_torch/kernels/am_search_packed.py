"""Associative search over the packed 1-bit AM: XOR + popcount.

Port of ``repro.kernels.am_search_packed`` (``csrc/am_search_packed.cu``).
The resident AM is the uint8-packed ``pack_rows`` layout (8 cells/byte,
LSB-first along D) and queries arrive packed the same way; similarity
uses the bipolar Hamming identity

    dot(q, a) = D_valid - 2 * popcount(bits(q) XOR bits(a)),

with a first-wins argmax. ``mode="unpack"`` instead unpacks both
operands to ±1 (0 past D) in shared memory and takes the float dot; the
two modes return the same (idx, sim) bit for bit.

A CPU tensor is searched by the plain version (``ref.am_search_packed``,
``ref.am_search_packed_unpack``); a CUDA tensor goes through the kernel
or raises. ``am_search_packed.launches`` counts popcount-mode launches,
``am_search_packed.unpack_launches`` unpack-mode launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pack_bits import pack_bits

# Queries per block: each instantiation of the kernel template (queries
# per thread 1, 2, 4, 8 over 4 thread rows).
BLOCK_B_CHOICES = (4, 8, 16, 32)
DEFAULT_BLOCK_B = 8
MODES = ("popcount", "unpack")
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use (H100)
_UNPACK_SLAB = 128    # dims per unpacked shared-memory slab


def pack_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, D) bipolar -> (B, ceil(D/8)) uint8, LSB-first; D-tail bits 0.

    The query-side packer: pads the trailing dimension to a byte boundary
    with -1 (bit 0) so tail bits XOR-cancel against the identically
    padded AM, then packs with ``pack_bits``.
    """
    x = x.float()
    pad = -x.shape[-1] % 8
    if pad:
        x = F.pad(x, (0, pad), value=-1.0)
    return pack_bits(x.contiguous())


def _smem_bytes(block_b: int, dp: int, mode: str) -> int:
    if mode == "unpack":
        return 4 * (block_b * _UNPACK_SLAB + _UNPACK_SLAB * 64
                    + 2 * block_b * 64)
    dw = -(-dp // 4)
    return 4 * (block_b * dw + dw * 64 + 2 * block_b * 64)


def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor, *,
                     n_dims: int, block_b: int = DEFAULT_BLOCK_B,
                     mode: str = "popcount",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the packed 1-bit AM.

    Args:
      q_packed: (B, Dp) uint8 queries, Dp = ceil(D/8), tail bits 0.
      am_packed_t: (Dp, C) uint8 transposed packed AM (``pack_am``).
      n_dims: true (unpacked) hypervector dimension D.
      block_b: queries per thread block (one of ``BLOCK_B_CHOICES``).
      mode: "popcount" (XOR + popcount) or "unpack" (±1 float dot).

    Returns:
      (best_idx, best_sim): (B,) int32 winning centroid (first wins ties)
      and (B,) float32 its bipolar dot similarity.
    """
    if mode not in MODES:
        raise ValueError(f"bad mode: {mode!r}")
    b, dp = q_packed.shape
    dp2, c = am_packed_t.shape
    if dp != dp2:
        raise ValueError(f"packed widths differ: {tuple(q_packed.shape)} "
                         f"vs {tuple(am_packed_t.shape)}")
    if not dp * 8 >= n_dims > (dp - 1) * 8:
        raise ValueError(f"n_dims={n_dims} inconsistent with Dp={dp}")
    if c == 0:
        raise ValueError("the AM has no columns")
    if q_packed.device != am_packed_t.device:
        raise ValueError("q_packed and am_packed_t on different devices")
    if q_packed.device.type == "cpu":
        if mode == "unpack":
            return ref.am_search_packed_unpack(q_packed, am_packed_t, n_dims)
        return ref.am_search_packed(q_packed, am_packed_t, n_dims)
    if q_packed.device.type != "cuda":
        raise ValueError(f"am_search_packed: unsupported device "
                         f"{q_packed.device}")
    _build.check_operand(q_packed, "q_packed", torch.uint8, 2)
    _build.check_operand(am_packed_t, "am_packed_t", torch.uint8, 2)
    if block_b not in BLOCK_B_CHOICES:
        raise ValueError(f"block_b={block_b} not in {BLOCK_B_CHOICES}")
    if _smem_bytes(block_b, dp, mode) > _SMEM_LIMIT:
        raise ValueError(f"D={n_dims} needs more shared memory than a "
                         f"block has at block_b={block_b}")
    idx = torch.empty((b,), dtype=torch.int32, device=q_packed.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q_packed.device)
    if b == 0:
        return idx, sim
    lib = _build.lib()
    with torch.cuda.device(q_packed.device):
        err = lib.am_search_packed_launch(
            q_packed.data_ptr(), am_packed_t.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, dp, c, n_dims, block_b, MODES.index(mode),
            _build.stream_of(q_packed))
    _build.check(err, "am_search_packed")
    if mode == "unpack":
        am_search_packed.unpack_launches += 1
    else:
        am_search_packed.launches += 1
    return idx, sim


am_search_packed.launches = 0
am_search_packed.unpack_launches = 0
