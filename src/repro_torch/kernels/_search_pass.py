"""The launch plan and route test of the two-route search pass.

Mirrors ``csrc/adc_tile.cuh`` (``adc::Plan``: the search grid, the slab
walk, the convert pass and the scratch, shared by ``am_search_imc``,
``am_search_multibit`` and ``am_search``) and ``csrc/search_pass.cuh``
(the search pass of ``am_search_imc.cu`` and ``am_search.cu``: its
block, fp32 step and shared memory). The wrappers compute their plans
here and hand them to their launchers, which refuse any other.
"""
from __future__ import annotations

import torch

# csrc/adc_tile.cuh: columns of a search block and its threads, int8
# bytes of k per ring stage (D pads to it) and ring stages, the sum tile's
# row stride; csrc/int8_convert.cuh: the convert tile.
BLOCK_COLS, THREADS = 64, 256
K_STAGE = 128
INT8_STAGES = 4
SUM_LD = BLOCK_COLS + 1
CONV_TILE = 64
EXACT = 2 ** 24  # float32 integers are exact up to here
# csrc/search_pass.cuh: queries of a search block, dims per k step of the
# fp32 route (sgemm_tile.cuh T0) and the dynamic shared memory, the larger
# of the int8 ring (query and column rows) and the fp32 ring (3 steps of
# both float tiles), then the sum tile.
BLOCK_ROWS = 128
FP32_STEP = 32
SMEM = (max(INT8_STAGES * (BLOCK_ROWS + BLOCK_COLS) * K_STAGE,
            3 * (BLOCK_ROWS + BLOCK_COLS) * FP32_STEP * 4)
        + 4 * BLOCK_ROWS * SUM_LD)


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def plan(b: int, d: int, c: int, tile_rows: int, *, rows: int,
         am_copy: bool, threads: int, smem: int, fp32_step: int) -> dict:
    """The launch of an ADC search (``adc::Plan``): the search grid of
    (64-column, ``rows``-query) tiles, the slab walk (``slabs`` =
    ceil(D / tile_rows), ``k_stages`` int8 ring stages, ``k_steps`` fp32
    steps of ``fp32_step`` dims), the convert pass's grid (one 64 x 64
    tile of q, and of the AM if ``am_copy``, each) and the byte offsets of
    the scratch: the int8 copies (bp, kp) and (cp, kp), a flag word per
    convert tile, a uint64 key per query and a ticket per query tile."""
    n_ct, n_rt = -(-c // BLOCK_COLS), -(-b // rows)
    kp = -(-d // K_STAGE) * K_STAGE
    bp, cp = n_rt * rows, n_ct * BLOCK_COLS
    kt = kp // CONV_TILE
    n_am_tiles = kt * (cp // CONV_TILE) if am_copy else 0
    n_conv = n_am_tiles + kt * (bp // CONV_TILE)
    sizes = {"q8": bp * kp, "am8": cp * kp if am_copy else 0,
             "flags": 4 * n_conv, "keys": 8 * b, "tickets": 4 * n_rt}
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += _align256(size)
    return {"grid": (n_ct, n_rt), "threads": threads, "smem": smem,
            "slabs": -(-d // tile_rows), "k_stages": kp // K_STAGE,
            "k_steps": -(-d // fp32_step), "conv_grid": n_conv,
            "scratch_bytes": at, "kp": kp, "n_am_tiles": n_am_tiles,
            "offsets": offsets}


def search_plan(b: int, d: int, c: int, tile_rows: int) -> dict:
    """The search pass's launch for B queries against a (D, C) AM view,
    cut into ``tile_rows`` slabs (D for ``am_search``)."""
    return plan(b, d, c, tile_rows, rows=BLOCK_ROWS, am_copy=True,
                threads=THREADS, smem=SMEM, fp32_step=FP32_STEP)


def launch_args(p: dict) -> tuple:
    """The plan's fields in the launchers' argument order."""
    return (*p["grid"], p["threads"], p["smem"], p["slabs"], p["k_stages"],
            p["k_steps"], p["conv_grid"])


def small_integers(x: torch.Tensor) -> bool:
    """Every value an integer in [-127, 127] (the convert pass's flags)."""
    return bool(((x == torch.round(x)) & (x.abs() <= 127)).all())


def int8_route(q: torch.Tensor, am_t: torch.Tensor, tile_rows: int) -> bool:
    """Whether the search pass takes its int8 route for these operands:
    its test of the convert pass's flags, mirrored."""
    if not (small_integers(q) and small_integers(am_t)):
        return False
    return (int(q.abs().max()) * int(am_t.abs().max())
            * min(tile_rows, q.shape[1]) <= EXACT)
