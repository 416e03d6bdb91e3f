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
``am_search_packed.unpack_launches`` unpack-mode launches, and
``am_search_packed.route_launches`` popcount mode's launches by route
(``{"tile": n, "sweep": n}``, ``launch_plan``); the ``launch.
am_search_packed`` span carries the route as its ``route`` arg.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pack_bits import pack_bits
from repro_torch.obs.trace import annotate, traced

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
# popcount mode's sweep route (csrc/am_search_packed.cu search_sweep): a
# block of 8 warps holds 128 query rows and walks a group of 128-column
# tiles through a 4-stage ring; D <= 1024 (A fragments in registers). A
# group walks 4 column tiles at least, and its columns fit a key's 20
# bits. The route is taken from B >= 128 and B x C >= 2^21 (row, column)
# pairs, where the grid of query tiles x groups fills a quarter of the
# device at least (popcount_route).
SWEEP_ROWS, SWEEP_COLS, SWEEP_WARPS, SWEEP_STAGES = 128, 128, 8, 4
SWEEP_MAX_DP, SWEEP_MIN_PAIRS, SWEEP_MIN_WALK = 128, 1 << 21, 4
_SWEEP_ASTR, _SWEEP_MAX_WALK = 144, ((1 << 20) - 1) // 128
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


def sweep_groups(b: int, c: int, sms: int) -> int:
    """The sweep route's column groups (``popcount::sweep_groups``): one
    wave of blocks, sms // query tiles, with at least ``SWEEP_MIN_WALK``
    column tiles a group, at least 1, and at most ``_SWEEP_MAX_WALK``."""
    tiles, ct = -(-b // SWEEP_ROWS), -(-c // SWEEP_COLS)
    g = max(1, min(sms // tiles, ct // SWEEP_MIN_WALK))
    return max(g, -(-ct // _SWEEP_MAX_WALK))


def popcount_route(b: int, dp: int, c: int, sms: int) -> str:
    """"sweep" where a resident 128-row query tile pays: D <= 1024, B >=
    128, B x C of 2^21 (row, column) pairs or more, and query tiles x
    column groups at least a quarter of the device's SMs; "tile"
    elsewhere. On the H100 (PERF.md §6) the sweep takes 0.009 ms
    at any B of 256 to 4,096 over C = 1,024 (one short walk a block) and
    0.185 ms at B 4,096 x C 100,000; the tile route 0.0067 at B 256 x C
    1,024 and 0.0089 at B = C = 1,024 (1 M pairs), but 0.020 at B 4,096
    x C 1,024 (4 M pairs) and 1.48 ms at B 4,096 x C 100,000."""
    if dp > SWEEP_MAX_DP or b < SWEEP_ROWS or b * c < SWEEP_MIN_PAIRS:
        return "tile"
    blocks = -(-b // SWEEP_ROWS) * sweep_groups(b, c, sms)
    return "sweep" if 4 * blocks >= sms else "tile"


def sweep_plan(b: int, dp: int, c: int, sms: int) -> dict:
    """The sweep route's launch: ``popcount::search_sweep<ceil(Dp/32)>``."""
    ks = -(-dp // 32)
    tiles = -(-b // SWEEP_ROWS)
    groups = sweep_groups(b, c, sms)
    return {"route": "sweep", "rows": SWEEP_ROWS, "cols": SWEEP_COLS,
            "warps": SWEEP_WARPS, "groups": groups, "grid": (tiles, groups),
            "smem": (SWEEP_ROWS * (32 * ks + 16)
                     + SWEEP_STAGES * 32 * ks * _SWEEP_ASTR
                     + 4 * 4 * SWEEP_ROWS),
            "scratch_bytes": 8 * b + 4 * tiles, "sms": sms}


def tile_plan(b: int, dp: int, c: int, block_b: int, sms: int) -> dict:
    """The tile route's launch: ``popcount::search<rows / 16, ...>``."""
    rows = max(16, block_b)
    cols = popcount_cols(b, c, rows, sms)
    warps = min(4, cols // 8)
    tiles = -(-b // rows)
    return {"route": "tile", "rows": rows, "cols": cols, "warps": warps,
            "grid": (tiles, -(-c // cols)),
            "smem": (_STAGES * (rows * _QSTR + _SLAB * max(cols + 16, 32))
                     + 8 * warps * rows),
            "scratch_bytes": 8 * b + 4 * tiles, "sms": sms}


def launch_plan(b: int, dp: int, c: int, block_b: int, mode: str,
                sms: int) -> dict:
    """The kernel's launch for B queries, Dp packed bytes and C columns on
    a device of ``sms`` SMs (``multi_processor_count``; 132 on an H100).

    Both modes: a grid of (query tiles, column splits), and a scratch of a
    uint64 key per query and a ticket word per query tile, all ones before
    and after a launch (``fold_scratch``). ``sms`` is part of the plan,
    and the launcher refuses a plan made for another device.

    popcount, two routes of one algorithm (AND + popcount on the b1
    tensor cores, then the first-wins key fold), picked by
    ``popcount_route`` from (B, Dp, C, sms) alone (D <= 1024, B >= 128,
    B x C >= 2^21 and a grid of a quarter of the SMs: sweep):

    * "tile" (``tile_plan``): ``rows`` = max(16, block_b) queries (one or
      two m16 tiles of ``mma.sync`` b1) by ``cols`` = ``popcount_cols``
      columns, a block of ``warps`` = min(4, cols / 8) warps, each block
      one column split. The dynamic shared memory is the 4-stage ring of
      32-byte k slabs of both operands (rows of 48 query bytes, then 32
      AM byte rows of max(cols + 16, 32) bytes), the same at any D, then
      the warps' uint64 keys of each row. Tuned at B = C = 1024 (0.0086
      ms) and B = 32 (0.0058 ms); at B 4,096 x C 100,000 its 200,192
      blocks of 16 x 128 each read 16 KB of AM for 64 mma (1.50 ms).
    * "sweep" (``sweep_plan``): ``rows`` = 128 queries held for the whole
      launch by ``warps`` = 8 (64 x 32 warp tiles), ``cols`` = 128
      columns a tile, a grid of (query tiles, ``groups`` =
      ``sweep_groups``), each block walking its group's column tiles in
      order through a 4-stage ring and folding once at the end. Dynamic
      shared memory: the query tile (rows 32 ceil(Dp/32) + 16 bytes),
      the ring (32 ceil(Dp/32) rows of 144 bytes a tile) and the column
      warps' uint32 keys of each row: 94,208 bytes at D = 1024.
      ``block_b`` does not enter it. 0.185 ms at B 4,096 x C 100,000.

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
    if popcount_route(b, dp, c, sms) == "sweep":
        return sweep_plan(b, dp, c, sms)
    return tile_plan(b, dp, c, block_b, sms)


def _launch(q_packed: torch.Tensor, am_packed_t: torch.Tensor, n_dims: int,
            block_b: int, mode: str, plan: dict
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``plan`` (checked operands, any route; the launcher
    refuses a plan that is not its own for the route). Counts nothing:
    ``chip_smoke.py`` times both routes at one shape through it."""
    b, dp = q_packed.shape
    c = am_packed_t.shape[1]
    if plan["grid"][1] > _MAX_GRID_Y:
        raise ValueError(f"C={c} needs more column splits than a grid has")
    idx = torch.empty((b,), dtype=torch.int32, device=q_packed.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q_packed.device)
    if b == 0:
        return idx, sim
    stream = _build.stream_of(q_packed)
    buf = fold_scratch(q_packed.device, stream, plan["scratch_bytes"])
    code = 2 if plan.get("route") == "sweep" else MODES.index(mode)
    lib = _build.lib()
    with torch.cuda.device(q_packed.device):
        err = lib.am_search_packed_launch(
            q_packed.data_ptr(), am_packed_t.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), buf.data_ptr(), b, dp,
            c, n_dims, block_b, code, plan["rows"],
            plan["cols"], *plan["grid"], plan["smem"], plan["scratch_bytes"],
            plan["sms"], stream)
    if err:
        _SCRATCH.pop((q_packed.device, stream), None)
    _build.check(err, "am_search_packed")
    return idx, sim


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
    route = plan.get("route")
    if route:
        annotate(route=route)
    idx, sim = _launch(q_packed, am_packed_t, n_dims, block_b, mode, plan)
    if b == 0:
        return idx, sim
    if mode == "unpack":
        am_search_packed.unpack_launches += 1
    else:
        am_search_packed.launches += 1
        am_search_packed.route_launches[route] += 1
    counts = am_search_packed.block_b_launches
    counts[block_b] = counts.get(block_b, 0) + 1
    return idx, sim


am_search_packed.launches = 0
am_search_packed.unpack_launches = 0
am_search_packed.block_b_launches = {}  # block_b -> launches (both modes)
am_search_packed.route_launches = {"tile": 0, "sweep": 0}  # popcount mode
