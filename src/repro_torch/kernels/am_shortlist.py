"""Coarse pass of the hierarchical AM search: the top-S cluster shortlist.

Port of ``repro.kernels.am_shortlist`` (``csrc/am_shortlist.cu``). Each
query is scored against the G packed super-centroids (one per cluster of
the trained AM) by XOR + popcount, sim = D - 2 * hamming, and the S best
clusters are kept, ordered by (-sim, cluster id): among equal
similarities the lower cluster id comes first, as in ``ref.am_shortlist``.
Every similarity is an integer, so kernel and plain version agree bit for
bit.

The kernel has two routes, which ``launch_plan`` picks from the shapes
before the launch (the launcher refuses any other plan): ``tile`` (16
query rows a block on the 1-bit tensor cores, a warp's exact top-S per
row, G split over blocks past 512 columns or where the card would idle,
merged by the last block of a query tile) wherever a warp's 512 keys
hold a row's candidates, else ``stream`` (a block per query, its keys in shared memory or, past
``SMEM_SLOTS``, in a global scratch). ``route_counts()`` counts the
launches of each.

A CPU tensor goes through the plain version (``ref.am_shortlist``); a
CUDA tensor through the kernel or raises. ``am_shortlist.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.obs.trace import traced

NEG = ref.NEG
_SENT = ref._SENT
# Candidates whose keys a block keeps in shared memory (8 bytes each);
# beyond it the kernel streams them through a global scratch buffer. A
# kernel that also stages tiles in shared memory (am_search_sparse's ring)
# counts them against the same 8 * SMEM_SLOTS bytes.
SMEM_SLOTS = 16384
# csrc/am_shortlist.cu tile route: query rows of a block (one m16 tile,
# a warp a row), the most keys a warp selects from (16 a lane), the
# columns of the narrow G split (2 keys a lane); the b1_slab.cuh ring
# (stages, bytes of a k slab, row stride of a query). Stream route:
# threads of its block (one per query).
ROWS, MAX_KEYS, MIN_SPLIT_COLS = 16, 512, 64
_STAGES, _SLAB, _QSTR = 4, 32, 48
STREAM_THREADS = 256
BLOCK_B_CHOICES = (ROWS,)
ROUTES = ("tile", "stream")
_ROUTE_COUNTS = dict.fromkeys(ROUTES, 0)
_TICKETS: dict[tuple, torch.Tensor] = {}


def route_counts() -> dict[str, int]:
    """Launches per route since the last reset."""
    return dict(_ROUTE_COUNTS)


def reset_routes() -> None:
    for r in ROUTES:
        _ROUTE_COUNTS[r] = 0


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _tile_cols(g: int, splits: int) -> int:
    return _up(-(-g // splits), 16)


def _merge_fits(g: int, s: int, cols: int) -> bool:
    splits = -(-g // cols)
    return splits == 1 or splits * min(s, cols) <= MAX_KEYS


def launch_plan(b: int, dp: int, g: int, s: int, sms: int) -> dict:
    """The kernel's launch for B queries of Dp packed bytes against G
    super-centroids, top S, on a device of ``sms`` SMs
    (``multi_processor_count``; 132 on an H100); ``csrc/am_shortlist.cu``
    ``tile::plan`` mirrors it.

    Tile route: a (query tiles of 16 rows, G splits) grid of 512-thread
    blocks. A split has ``cols`` columns (a multiple of 16, at most 512):
    the fewest splits, or splits of ``MIN_SPLIT_COLS`` where that grid has
    at most one block an SM and their merge's ``splits * min(S, cols)`` keys
    are fewer than the fewest splits' columns. The merge's keys must fit a
    warp's 512 (else the stream route). A narrow split's selection (fewer
    keys a lane) pays for the merge only while no SM runs two blocks: at G =
    448, S = 8 on an H100 80GB HBM3 at 700.00 W the 7 splits took 0.00834 ms
    against one split's 0.00934 at B = 256 (112 blocks), and 0.00979 /
    0.01495 / 0.02389 against 0.00961 / 0.00983 / 0.01094 at B = 512 / 1024
    / 2048 (``chip_smoke.py``'s ``ms_by_batch``; fewer, wider splits lost at
    every batch). ``kpl``: the keys a lane holds (even, 2-16); ``smem``: the
    larger of the b1_slab.cuh ring and the 16 rows' keys; ``scratch_bytes``:
    the merge keys (0 with one split); ``ticket_bytes``: a word per query
    tile, all ones (0 with one split).

    Stream route: a block of 256 threads per query; the G keys in shared
    memory up to ``SMEM_SLOTS``, else a (B, G) global scratch."""
    tiles = -(-b // ROWS)
    cols = _tile_cols(g, -(-g // MAX_KEYS))
    narrow = -(-g // MIN_SPLIT_COLS)
    if (tiles * narrow <= sms and MIN_SPLIT_COLS < cols
            and narrow * min(s, MIN_SPLIT_COLS) < cols):
        cols = MIN_SPLIT_COLS
    if _merge_fits(g, s, cols):
        n_split = -(-g // cols)
        merge = n_split * min(s, cols) if n_split > 1 else 0
        kpl = _up(-(-max(cols, merge) // 32), 2)
        ring = _STAGES * (ROWS * _QSTR + _SLAB * max(cols + 16, 32))
        return {"route": "tile", "splits": n_split, "cols": cols,
                "kpl": kpl, "grid": (tiles, n_split), "threads": 32 * ROWS,
                "smem": max(ring, 8 * ROWS * (32 * kpl + 1)),
                "scratch_bytes": 8 * tiles * ROWS * merge,
                "ticket_bytes": 4 * tiles if n_split > 1 else 0, "sms": sms}
    fit = g <= SMEM_SLOTS
    return {"route": "stream", "splits": 1, "cols": 0, "kpl": 0,
            "grid": (b, 1), "threads": STREAM_THREADS,
            "smem": (8 * g if fit else 0) + 4 * -(-dp // 4)
            + 4 * (STREAM_THREADS // 32),
            "scratch_bytes": 0 if fit else 8 * b * g, "ticket_bytes": 0,
            "sms": sms}


def topk_select(sims: torch.Tensor, ids: torch.Tensor, k: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of (sims, ids) pairs ordered by (-sim, id), as k
    iterated max-then-min-id selections (the TPU kernels' epilogue).

    sims: (B, N) float32, ids: (B, N) int32. Returns ((B, k) sims,
    (B, k) ids), best first; exhausted slots decay to (float32-min,
    int32-max). No composite sort key: an int32 (sim, id) pack overflows
    once D * C passes 2^31, and float keys lose id bits.
    """
    out_s, out_i = [], []
    for _ in range(k):
        m = sims.max(dim=1, keepdim=True).values
        pick = torch.where(sims == m, ids, _SENT).min(dim=1,
                                                       keepdim=True).values
        out_s.append(m)
        out_i.append(pick)
        drop = (sims == m) & (ids == pick)
        sims = torch.where(drop, NEG, sims)
        ids = torch.where(drop, _SENT, ids)
    return torch.cat(out_s, dim=1), torch.cat(out_i, dim=1)


def check_packed(q_packed: torch.Tensor, am_t: torch.Tensor, n_dims: int,
                 what: str) -> None:
    """Refuse packed operands whose widths or devices disagree."""
    if q_packed.dim() != 2 or am_t.dim() < 2:
        raise ValueError(f"{what}: bad ranks {tuple(q_packed.shape)}, "
                         f"{tuple(am_t.shape)}")
    dp = q_packed.shape[1]
    if am_t.shape[-2] != dp:
        raise ValueError(f"{what}: packed widths differ: "
                         f"{tuple(q_packed.shape)} vs {tuple(am_t.shape)}")
    if not dp * 8 >= n_dims > (dp - 1) * 8:
        raise ValueError(f"n_dims={n_dims} inconsistent with Dp={dp}")
    if q_packed.device != am_t.device:
        raise ValueError(f"{what}: operands on different devices")
    if q_packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q_packed.device}")


def keys_fit(slots: int, reserved: int = 0) -> bool:
    """Whether a block keeps its ``slots`` keys in shared memory beside
    ``reserved`` bytes of other staging."""
    return 8 * slots + reserved <= 8 * SMEM_SLOTS


@traced("launch.am_shortlist")
def am_shortlist(q_packed: torch.Tensor, super_packed_t: torch.Tensor, *,
                 n_dims: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Score packed queries against G packed super-centroids, keep top S.

    Args:
      q_packed: (B, Dp) uint8 packed queries (``pack_rows``), tail bits 0.
      super_packed_t: (Dp, G) uint8 transposed packed super-centroids.
      n_dims: true hypervector dimension D.
      s: shortlist length, 1 <= s <= G.

    Returns:
      (cluster_idx, cluster_sims): (B, s) int32 and (B, s) float32,
      best first, ties toward the lower cluster id.
    """
    idx, sim, route = _launch(q_packed, super_packed_t, n_dims, s)
    if route is not None:
        am_shortlist.launches += 1
        _ROUTE_COUNTS[route] += 1
    return idx, sim


am_shortlist.launches = 0


def _launch(q_packed, super_packed_t, n_dims, s, sms=None):
    """(idx, sim, the route launched or None). ``sms``: the SM count whose
    ``launch_plan`` the launch takes (None: the device's). Every plan
    gives the same result; only a measurement asks for another device's
    grid."""
    check_packed(q_packed, super_packed_t, n_dims, "am_shortlist")
    if super_packed_t.dim() != 2:
        raise ValueError("am_shortlist: super_packed_t must be (Dp, G)")
    b, dp = q_packed.shape
    g = super_packed_t.shape[1]
    if not 1 <= s <= g:
        raise ValueError(f"shortlist s={s} outside [1, {g}]")
    if q_packed.device.type == "cpu":
        return (*ref.am_shortlist(q_packed, super_packed_t, n_dims, s), None)
    _build.check_operand(q_packed, "q_packed", torch.uint8, 2)
    _build.check_operand(super_packed_t, "super_packed_t", torch.uint8, 2)
    dev = q_packed.device
    idx = torch.empty((b, s), dtype=torch.int32, device=dev)
    sim = torch.empty((b, s), dtype=torch.float32, device=dev)
    if b == 0:
        return idx, sim, None
    if sms is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = launch_plan(b, dp, g, s, sms)
    stream = _build.stream_of(q_packed)
    buf = (torch.empty((plan["scratch_bytes"],), dtype=torch.uint8,
                       device=dev) if plan["scratch_bytes"] else None)
    tickets = (_build.ones_buffer(_TICKETS, dev, stream,
                                  plan["ticket_bytes"])
               if plan["ticket_bytes"] else None)
    lib = _build.lib()
    with torch.cuda.device(dev):
        err = lib.am_shortlist_launch(
            q_packed.data_ptr(), super_packed_t.data_ptr(),
            None if buf is None else buf.data_ptr(),
            None if tickets is None else tickets.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, dp, g, n_dims, s,
            ROUTES.index(plan["route"]), plan["splits"], plan["cols"],
            plan["kpl"], *plan["grid"], plan["smem"], plan["scratch_bytes"],
            plan["sms"], stream)
    if err:
        _TICKETS.pop((dev, stream), None)
    _build.check(err, "am_shortlist")
    return idx, sim, plan["route"]
