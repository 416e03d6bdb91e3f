"""Fine pass of the hierarchical AM search: shortlisted tiles + top-k.

Port of ``repro.kernels.am_search_sparse`` (``csrc/am_search_sparse.cu``).
The AM has been permuted offline so every cluster owns a contiguous run
of 128-column packed tiles of one slab
(``deploy.hierarchical.build_layout``), with a trailing all-invalid null
tile. A query needs only the tiles of its S shortlisted clusters:
``expand_shortlist_tiles`` turns its (S,) shortlist into S * max_tiles
slab tiles (the null tile past a cluster's ``tile_count``), and the
search keeps the top k columns by (-sim, ORIGINAL centroid id) — so with
S = G the k = 1 column equals the flat ``am_search_packed`` scan bit for
bit. Columns whose id is -1 are masked; slots with no candidate left are
(-1, float32-min).

``am_search_sparse`` is the whole fine pass: its kernel reads each
query's tiles straight from the slab through the layout, so the
reference's (B, Dp, S * max_tiles * 128) gather never exists. A
shortlist entry outside [0, G) and a tile outside the slab read as the
null tile, in the kernel and the plain version alike.
``am_search_sparse_gathered`` takes that gather (``gather_shortlist``),
as the TPU kernel does; it is a second entry of the same CUDA source.

``launch_plan`` is the kernel's grid, tile ring and shared memory (and
whether the keys stay there), computed here so that the CPU tests can
check it and handed to the launcher, which refuses a plan other than its
own.

A CPU tensor goes through the plain version (gather, then
``ref.am_search_sparse``); a CUDA tensor through the kernel or raises.
Each function's ``.launches`` counts its kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.am_shortlist import check_packed, keys_fit
from repro_torch.obs.trace import traced

TILE = 128  # slab columns per tile (the am_search_packed contract)
# csrc/am_search_sparse.cu: threads per block (one block per query), ring
# stages, most tile rows (packed bytes of D) a ring stage holds.
THREADS, STAGES, MAX_CHUNK_ROWS = 256, 3, 128
BLOCK_B_CHOICES = (1,)  # queries per block: the kernel's only tile
BLOCK_SMEM = 232448  # shared memory one block may opt into (H100)


def launch_plan(b: int, dp: int, n_slots: int) -> dict:
    """One block per query over ``n_slots`` candidate columns (whole
    128-column tiles) of Dp packed bytes: a ring of ``stages`` stages of
    ``chunk_rows`` tile rows (Dp rounded up to 4, at most 128; a larger Dp
    is read in chunks) and the tile's 128 int32 ids; the keys stay in
    shared memory (``keys_in_smem``) when they fit beside the ring, else
    they go to a (B, n_slots) global scratch; ``smem`` is the dynamic
    shared memory: the ring, the keys if kept, the query's words over
    whole chunks, a word per slot tile and one per warp."""
    cr = min(-(-dp // 4) * 4, MAX_CHUNK_ROWS)
    chunks = -(-dp // cr)
    ring = STAGES * (cr + 4) * TILE
    in_smem = keys_fit(n_slots, ring)
    smem = (ring + (8 * n_slots if in_smem else 0) + 4 * chunks * (cr // 4)
            + 4 * (n_slots // TILE) + 4 * (THREADS // 32))
    return {"grid": b, "stages": STAGES, "chunk_rows": cr,
            "keys_in_smem": in_smem, "smem": smem}


def _plan_for(b: int, dp: int, n_slots: int, what: str) -> dict:
    plan = launch_plan(b, dp, n_slots)
    if plan["smem"] > BLOCK_SMEM:
        raise ValueError(f"{what}: {n_slots} candidate columns need "
                         f"{plan['smem']} bytes of shared memory per "
                         f"block, over {BLOCK_SMEM}")
    return plan


def _check_aligned(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads it in 16-byte copies; "
                         "its data must start 16-byte aligned")


def _keys_scratch(plan: dict, b: int, n_slots: int, device):
    if plan["keys_in_smem"]:
        return None
    return torch.empty((b, n_slots), dtype=torch.int64, device=device)


def expand_shortlist_tiles(shortlist: torch.Tensor, tile_start: torch.Tensor,
                           tile_count: torch.Tensor, *, max_tiles: int,
                           null_tile: int) -> torch.Tensor:
    """(B, S) cluster shortlist -> (B, S * max_tiles) int64 slab tiles;
    slots past a cluster's ``tile_count``, of a shortlist entry outside
    [0, G) or outside [0, null_tile] point at ``null_tile``."""
    j = torch.arange(max_tiles, device=shortlist.device)
    sl = shortlist.long()
    g = tile_start.shape[0]
    known = (sl >= 0) & (sl < g)
    sl = torch.where(known, sl, 0)
    ts = tile_start.long()[sl]  # (B, S)
    tc = torch.where(known, tile_count.long()[sl], 0)
    tiles = ts[:, :, None] + j[None, None, :]
    keep = (j[None, None, :] < tc[:, :, None]) & (tiles >= 0) & (
        tiles <= null_tile)
    tiles = torch.where(keep, tiles, null_tile)
    return tiles.reshape(shortlist.shape[0], -1)


def gather_shortlist(am_slab_t: torch.Tensor, col_ids: torch.Tensor,
                     tiles: torch.Tensor,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather per-query tiles and their centroid ids from the slab:
    ((B, Dp, T*128) uint8, (B, T*128) int32)."""
    b, t = tiles.shape
    cols = (tiles.long()[:, :, None] * TILE
            + torch.arange(TILE, device=tiles.device)).reshape(b, t * TILE)
    gathered = am_slab_t[:, cols].permute(1, 0, 2).contiguous()
    return gathered, col_ids[cols]


def am_search_sparse_plain(q_packed, am_slab_t, col_ids, shortlist,
                           tile_start, tile_count, *, n_dims: int, k: int,
                           max_tiles: int,
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain fine pass on any device: expand, gather, then
    ``ref.am_search_sparse``."""
    tiles = expand_shortlist_tiles(
        shortlist, tile_start, tile_count, max_tiles=max_tiles,
        null_tile=am_slab_t.shape[1] // TILE - 1)
    gathered, ids = gather_shortlist(am_slab_t, col_ids, tiles)
    return ref.am_search_sparse(q_packed, gathered, ids, n_dims, k)


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")


def am_search_sparse_gathered(q_packed: torch.Tensor,
                              tiles_packed: torch.Tensor,
                              tile_ids: torch.Tensor, *, n_dims: int, k: int,
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k search over pre-gathered per-query tiles.

    Args:
      q_packed: (B, Dp) uint8 packed queries, tail bits 0.
      tiles_packed: (B, Dp, T*128) uint8 gathered tiles.
      tile_ids: (B, T*128) int32 original centroid id per column, -1 for
        masked columns.
      n_dims: true hypervector dimension D.
      k: candidates to return, >= 1 (any k; slots past the valid
        columns are exhausted).

    Returns:
      (idx, sims): (B, k) int32 original ids and (B, k) float32 sims,
      ordered by (-sim, id); exhausted slots (-1, float32-min).
    """
    check_packed(q_packed, tiles_packed, n_dims, "am_search_sparse_gathered")
    b, dp = q_packed.shape
    if tiles_packed.dim() != 3 or tiles_packed.shape[0] != b:
        raise ValueError(f"tiles_packed {tuple(tiles_packed.shape)} is not "
                         f"(B={b}, Dp, T*128)")
    tc = tiles_packed.shape[2]
    if tuple(tile_ids.shape) != (b, tc):
        raise ValueError(f"tile_ids {tuple(tile_ids.shape)} != ({b}, {tc})")
    if tc % TILE:
        raise ValueError(f"gathered columns {tc} not a multiple of {TILE}")
    _check_k(k)
    if q_packed.device.type == "cpu":
        return ref.am_search_sparse(q_packed, tiles_packed, tile_ids,
                                    n_dims, k)
    if tile_ids.device != q_packed.device:
        raise ValueError("am_search_sparse_gathered: operands on different "
                         "devices")
    _build.check_operand(q_packed, "q_packed", torch.uint8, 2)
    _build.check_operand(tiles_packed, "tiles_packed", torch.uint8, 3)
    _build.check_operand(tile_ids, "tile_ids", torch.int32, 2)
    _check_aligned(tiles_packed, "tiles_packed")
    _check_aligned(tile_ids, "tile_ids")
    plan = _plan_for(b, dp, tc, "am_search_sparse_gathered")
    idx = torch.empty((b, k), dtype=torch.int32, device=q_packed.device)
    sim = torch.empty((b, k), dtype=torch.float32, device=q_packed.device)
    if b == 0:
        return idx, sim
    buf = _keys_scratch(plan, b, tc, q_packed.device)
    lib = _build.lib()
    with torch.cuda.device(q_packed.device):
        err = lib.am_search_sparse_gathered_launch(
            q_packed.data_ptr(), tiles_packed.data_ptr(), tile_ids.data_ptr(),
            None if buf is None else buf.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, dp, tc, n_dims, k, plan["grid"],
            plan["stages"], plan["chunk_rows"], plan["smem"],
            _build.stream_of(q_packed))
    _build.check(err, "am_search_sparse_gathered")
    am_search_sparse_gathered.launches += 1
    return idx, sim


am_search_sparse_gathered.launches = 0


@traced("launch.am_search_sparse")
def am_search_sparse(q_packed: torch.Tensor, am_slab_t: torch.Tensor,
                     col_ids: torch.Tensor, shortlist: torch.Tensor,
                     tile_start: torch.Tensor, tile_count: torch.Tensor, *,
                     n_dims: int, k: int, max_tiles: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fine pass over the cluster-contiguous slab.

    Args:
      q_packed: (B, Dp) uint8 packed queries.
      am_slab_t: (Dp, n_tiles*128) uint8 permuted slab whose LAST tile is
        the all-invalid null tile.
      col_ids: (n_tiles*128,) int32 original centroid id per slab column
        (-1 = padding).
      shortlist: (B, S) int32 cluster ids (``am_shortlist``).
      tile_start, tile_count: (G,) int32 each cluster's tiles.
      n_dims, k: as ``am_search_sparse_gathered``.
      max_tiles: tiles searched per shortlisted cluster (>= every
        ``tile_count``).

    Returns the same (idx, sims) as gathering with ``gather_shortlist``
    and calling ``am_search_sparse_gathered``.
    """
    check_packed(q_packed, am_slab_t, n_dims, "am_search_sparse")
    b, dp = q_packed.shape
    ctot = am_slab_t.shape[1]
    if am_slab_t.dim() != 2 or ctot % TILE or ctot == 0:
        raise ValueError(f"am_slab_t {tuple(am_slab_t.shape)} is not "
                         f"(Dp, n_tiles*{TILE})")
    if tuple(col_ids.shape) != (ctot,):
        raise ValueError(f"col_ids {tuple(col_ids.shape)} != ({ctot},)")
    if shortlist.dim() != 2 or shortlist.shape[0] != b:
        raise ValueError(f"shortlist {tuple(shortlist.shape)} is not (B, S)")
    if tile_start.shape != tile_count.shape or tile_start.dim() != 1:
        raise ValueError("tile_start and tile_count must be (G,) each")
    if max_tiles < 1:
        raise ValueError(f"max_tiles={max_tiles} must be >= 1")
    _check_k(k)
    if q_packed.device.type == "cpu":
        return am_search_sparse_plain(
            q_packed, am_slab_t, col_ids, shortlist, tile_start, tile_count,
            n_dims=n_dims, k=k, max_tiles=max_tiles)
    for t, name in ((col_ids, "col_ids"), (shortlist, "shortlist"),
                    (tile_start, "tile_start"), (tile_count, "tile_count")):
        if t.device != q_packed.device:
            raise ValueError(f"am_search_sparse: {name} on another device")
        _build.check_operand(t, name, torch.int32, t.dim())
    _build.check_operand(q_packed, "q_packed", torch.uint8, 2)
    _build.check_operand(am_slab_t, "am_slab_t", torch.uint8, 2)
    _check_aligned(am_slab_t, "am_slab_t")
    _check_aligned(col_ids, "col_ids")
    idx, sim, _ = _launch_fused(q_packed, am_slab_t, col_ids, shortlist,
                                tile_start, tile_count, n_dims=n_dims, k=k,
                                max_tiles=max_tiles, clocks=False)
    if b:
        am_search_sparse.launches += 1
    return idx, sim


am_search_sparse.launches = 0


def _launch_fused(q_packed, am_slab_t, col_ids, shortlist, tile_start,
                  tile_count, *, n_dims, k, max_tiles, clocks):
    """Launch the fused kernel on checked CUDA operands; with ``clocks``
    each block also records clock64() at its start, after scoring and at
    its end, returned as a (B, 3) int64 tensor."""
    b, dp = q_packed.shape
    s = shortlist.shape[1]
    dev = q_packed.device
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    sim = torch.empty((b, k), dtype=torch.float32, device=dev)
    clk = (torch.zeros((b, 3), dtype=torch.int64, device=dev) if clocks
           else None)
    if b == 0:
        return idx, sim, clk
    slots = s * max_tiles * TILE
    if slots >= 2 ** 31:
        raise ValueError(f"S * max_tiles * {TILE} = {slots} candidate "
                         "columns per query is too many for the kernel")
    plan = _plan_for(b, dp, slots, "am_search_sparse")
    buf = _keys_scratch(plan, b, slots, dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        err = lib.am_search_sparse_launch(
            q_packed.data_ptr(), am_slab_t.data_ptr(), col_ids.data_ptr(),
            shortlist.data_ptr(), tile_start.data_ptr(),
            tile_count.data_ptr(), None if buf is None else buf.data_ptr(),
            idx.data_ptr(), sim.data_ptr(),
            None if clk is None else clk.data_ptr(), b, dp,
            am_slab_t.shape[1], s, tile_start.shape[0], max_tiles, n_dims, k,
            plan["grid"], plan["stages"], plan["chunk_rows"], plan["smem"],
            _build.stream_of(q_packed))
    _build.check(err, "am_search_sparse")
    return idx, sim, clk


def phase_clocks(q_packed, am_slab_t, col_ids, shortlist, tile_start,
                 tile_count, *, n_dims: int, k: int, max_tiles: int,
                 ) -> torch.Tensor:
    """A measurement: one launch of the fused kernel on CUDA operands
    that records, per block (query), clock64() at its start, once its
    keys are scored and at its end ((B, 3) int64 SM cycles), so that the
    scoring and the selection can be timed apart. Not counted in
    ``am_search_sparse.launches``."""
    return _launch_fused(q_packed, am_slab_t, col_ids, shortlist,
                         tile_start, tile_count, n_dims=n_dims, k=k,
                         max_tiles=max_tiles, clocks=True)[2]
