"""Associative search over the packed 1-bit AM: Hamming distance + argmax.

Port of ``repro.kernels.am_search_packed`` (``csrc/am_search_packed.cu``).
The resident AM is the uint8-packed ``pack_rows`` layout (8 cells/byte,
LSB-first along D) and queries arrive packed the same way; similarity
uses the bipolar Hamming identity

    dot(q, a) = D_valid - 2 * popcount(bits(q) XOR bits(a)),

with a first-wins argmax. Popcount mode counts it on the 1-bit tensor
cores as popcount(q) + popcount(a) - 2 * popcount(q AND a);
``mode="unpack"`` instead takes the exact integer dot of both operands
unpacked to ±1 (0 past D) on the int8 tensor cores; the two modes return
the same (idx, sim) bit for bit.

``launch_plan`` is the kernel's grid, tiles, shared memory and scratch,
computed here so that the CPU tests can check it and handed to the
launcher, which refuses a plan other than its own.

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
from repro_torch.obs.trace import traced

# Queries per block: the rows of a query tile, rounded up to whole m16
# tiles of mma.sync, max(16, block_b), in both modes.
BLOCK_B_CHOICES = (4, 8, 16, 32)
DEFAULT_BLOCK_B = 8
MODES = ("popcount", "unpack")
# csrc/am_search_packed.cu, both modes: bytes per k slab, ring stages,
# the ring's row stride of a query; unpack mode: columns per block, warps,
# the ring's row stride of an AM byte row.
_SLAB, _STAGES, _QSTR = 32, 4, 48
UNPACK_COLS = 128
_WARPS, _ASTR = 4, UNPACK_COLS + 16
# popcount mode: the widest and narrowest column split (the grid is to
# have a block per SM of the device, ``popcount_cols``).
POPCOUNT_COLS, _MIN_COLS = 128, 8
_MAX_GRID_Y = 65535
# The reference's IMC tiling: 128 centroid columns by 16 packed bytes
# (128 dims) a cycle.
_CYCLE_COLS, _CYCLE_BYTES = 128, 16


def imc_cycles_for(am_packed_t_shape: tuple) -> int:
    """ceil(Dp/16) * ceil(C/128) array passes per query for a (Dp, C)
    packed AM: the reference's ``am_search_packed.imc_cycles_for``. A
    16-byte slab holds 128 dims, so this equals the unpacked AM's count
    and ``core.imc.map_memhd(D, C).cycles``."""
    dp, c = am_packed_t_shape
    return (-(-dp // _CYCLE_BYTES)) * (-(-c // _CYCLE_COLS))


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


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


_SCRATCH: dict[tuple, torch.Tensor] = {}


def fold_scratch(device: torch.device, stream: int,
                 nbytes: int) -> torch.Tensor:
    """The fold's scratch (keys and tickets) for launches on ``stream``:
    both modes start from all ones and leave it all ones
    (``_build.ones_buffer``)."""
    return _build.ones_buffer(_SCRATCH, device, stream, nbytes)


def popcount_cols(b: int, c: int, rows: int, sms: int) -> int:
    """Popcount mode's columns per block (``popcount::block_cols``): the
    widest of 128, 64, ..., 8 whose grid has a block per SM (``sms``
    blocks), else 8."""
    tiles, cols = -(-b // rows), POPCOUNT_COLS
    while cols > _MIN_COLS and tiles * -(-c // cols) < sms:
        cols //= 2
    return cols


def launch_plan(b: int, dp: int, c: int, block_b: int, mode: str,
                sms: int) -> dict:
    """The kernel's launch for B queries, Dp packed bytes and C columns on
    a device of ``sms`` SMs (``multi_processor_count``; 132 on an H100).

    Both modes: a grid of (query tiles, column splits), and a scratch of a
    uint64 key per query and a ticket word per query tile, all ones before
    and after a launch (``fold_scratch``). ``sms`` is part of the plan,
    and the launcher refuses a plan made for another device.

    popcount: ``rows`` = max(16, block_b) queries (one or two m16 tiles
    of ``mma.sync`` b1) by ``cols`` = ``popcount_cols`` columns, a block of
    ``warps`` = min(4, cols / 8) warps. The dynamic shared memory is the
    4-stage ring of 32-byte k slabs of both operands (rows of 48 query
    bytes, then 32 AM byte rows of max(cols + 16, 32) bytes), the same at
    any D, then the warps' uint64 keys of each row.

    unpack: a block of 4 warps per ``rows`` = max(16, block_b) queries
    (one or two m16 tiles of ``mma.sync``) and ``cols`` = 128 columns. The
    shared memory is the kernel's static ``Smem`` (a 4-stage ring of
    32-byte k slabs of both operands, the warps' keys and shares of the
    rows' popcounts, the last block's flag).
    """
    if mode == "unpack":
        rows = max(16, block_b)
        tiles = -(-b // rows)
        ring = _STAGES * rows * _QSTR + _STAGES * _SLAB * _ASTR
        smem = _up(_up(ring, 8) + 12 * _WARPS * rows + 4, 8)
        return {"rows": rows, "cols": UNPACK_COLS,
                "grid": (tiles, -(-c // UNPACK_COLS)), "smem": smem,
                "scratch_bytes": 8 * b + 4 * tiles, "sms": sms}
    rows = max(16, block_b)
    cols = popcount_cols(b, c, rows, sms)
    warps = min(4, cols // 8)
    tiles = -(-b // rows)
    return {"rows": rows, "cols": cols, "warps": warps,
            "grid": (tiles, -(-c // cols)),
            "smem": (_STAGES * (rows * _QSTR + _SLAB * max(cols + 16, 32))
                     + 8 * warps * rows),
            "scratch_bytes": 8 * b + 4 * tiles, "sms": sms}


@traced("launch.am_search_packed")
def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor, *,
                     n_dims: int, block_b: int | None = DEFAULT_BLOCK_B,
                     mode: str = "popcount",
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the packed 1-bit AM.

    Args:
      q_packed: (B, Dp) uint8 queries, Dp = ceil(D/8), tail bits 0.
      am_packed_t: (Dp, C) uint8 transposed packed AM (``pack_am``).
      n_dims: true (unpacked) hypervector dimension D.
      block_b: rows of a query tile (one of ``BLOCK_B_CHOICES``; None:
        ``DEFAULT_BLOCK_B``), rounded up to the 16 rows of an ``mma.sync``
        tile in both modes (4, 8 and 16 give 16-row blocks, 32 two m16
        tiles).
      mode: "popcount" (XOR + popcount) or "unpack" (the ±1 dot, exact,
        on the int8 tensor cores).

    Returns:
      (best_idx, best_sim): (B,) int32 winning centroid (first wins ties)
      and (B,) float32 its bipolar dot similarity.
    """
    if mode not in MODES:
        raise ValueError(f"bad mode: {mode!r}")
    block_b = DEFAULT_BLOCK_B if block_b is None else block_b
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
    sms = torch.cuda.get_device_properties(
        q_packed.device).multi_processor_count
    plan = launch_plan(b, dp, c, block_b, mode, sms)
    if plan["grid"][1] > _MAX_GRID_Y:
        raise ValueError(f"C={c} needs more column splits than a grid has")
    idx = torch.empty((b,), dtype=torch.int32, device=q_packed.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q_packed.device)
    if b == 0:
        return idx, sim
    stream = _build.stream_of(q_packed)
    buf = fold_scratch(q_packed.device, stream, plan["scratch_bytes"])
    lib = _build.lib()
    with torch.cuda.device(q_packed.device):
        err = lib.am_search_packed_launch(
            q_packed.data_ptr(), am_packed_t.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), buf.data_ptr(), b, dp,
            c, n_dims, block_b, MODES.index(mode), plan["rows"],
            plan["cols"], *plan["grid"], plan["smem"], plan["scratch_bytes"],
            plan["sms"], stream)
    if err:
        _SCRATCH.pop((q_packed.device, stream), None)
    _build.check(err, "am_search_packed")
    if mode == "unpack":
        am_search_packed.unpack_launches += 1
    else:
        am_search_packed.launches += 1
    counts = am_search_packed.block_b_launches
    counts[block_b] = counts.get(block_b, 0) + 1
    return idx, sim


am_search_packed.launches = 0
am_search_packed.unpack_launches = 0
am_search_packed.block_b_launches = {}  # block_b -> launches (both modes)
