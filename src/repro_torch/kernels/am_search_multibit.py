"""Bit-sliced multi-bit associative search: wrapper of the
``am_search_multibit`` CUDA kernel.

Port of ``repro.kernels.am_search_multibit``
(``csrc/am_search_multibit.cu``). The resident AM is a symmetric
``cell_bits``-bit quantization of the float AM shadow, stored as offset
codes u = code + Qmax in bit planes (``ref.pack_planes``), and the
search runs the ``am_search_imc`` tiled-ADC pipeline in the integer code
domain: with bipolar queries every partial sum is an integer, so the
kernel equals ``ref.am_search_multibit`` bit for bit. Multiply the
returned similarity by the quantizer scale for its dequantized value.

The kernel picks its route on the device, per call: integer queries in
[-127, 127] whose slab partials are exact (``int8_route``: ±1 queries)
run on the int8 tensor cores against u8 codes decoded straight from the
planes; other queries (e.g. dyadic fractions) through the SIMT fp32
tile. ``route_counts()`` / ``reset_routes()`` as in ``am_search_imc``;
``launch_plan`` is handed to the launcher, which refuses any other.

A CPU tensor goes through the plain version; a CUDA tensor through the
kernel or raises. ``am_search_multibit.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._search_pass import (
    BLOCK_COLS, EXACT, INT8_STAGES, K_STAGE, SUM_LD, THREADS, launch_args,
    plan, small_integers,
)
from repro_torch.kernels.am_search_imc import check_readout

# csrc/am_search_multibit.cu: queries of a search block (its one
# configuration, which the autotuner times; a wider tile is kernel work,
# ROADMAP 2b), dims per k step of the fp32 route (the SIMT tile of
# csrc/sims_argmax.cuh) and the dynamic shared memory: the ring (each
# stage the int8 query rows and up to 8 planes' 16 bytes of k for each
# column), the decoded u8 code rows, the sum tile.
BLOCK_ROWS = 64
BLOCK_B_CHOICES = (BLOCK_ROWS,)
FP32_STEP = 16
MAX_PLANES = 8
SMEM = (INT8_STAGES * (BLOCK_ROWS * K_STAGE
                       + MAX_PLANES * (K_STAGE // 8) * BLOCK_COLS)
        + BLOCK_COLS * K_STAGE + 4 * BLOCK_ROWS * SUM_LD)
ROUTES = _build.RouteCounts.NAMES
_ROUTES = _build.RouteCounts()


def launch_plan(b: int, d: int, c: int, tile_rows: int) -> dict:
    """``am_search_multibit``'s launch for B queries against C columns of
    D dims (``_search_pass.plan`` without the AM copy)."""
    return plan(b, d, c, tile_rows, rows=BLOCK_ROWS, am_copy=False,
                threads=THREADS, smem=SMEM, fp32_step=FP32_STEP)


def int8_route(q: torch.Tensor, cell_bits: int, tile_rows: int) -> bool:
    """Whether the kernel takes its int8 route for these queries: integers
    in [-127, 127] with max|q| * (Qmax + 1) * min(tile_rows, D) <= 2^24,
    Qmax + 1 the largest |u - Qmax| a code can hold."""
    qmax = 2 ** (cell_bits - 1) - 1
    return small_integers(q) and (int(q.abs().max()) * (qmax + 1)
                                  * min(tile_rows, q.shape[1]) <= EXACT)


def routes(device: torch.device) -> torch.Tensor:
    """The (2,) int32 device counter of calls per route on ``device``."""
    return _ROUTES.tensor(device)


def route_counts() -> dict[str, int]:
    """Calls per route since the last reset, over all devices."""
    return _ROUTES.counts()


def reset_routes() -> None:
    _ROUTES.reset()


def am_search_multibit(q: torch.Tensor, am_planes_t: torch.Tensor,
                       offsets: torch.Tensor | None = None, *,
                       cell_bits: int, tile_rows: int = 128,
                       tile_cols: int = 128, adc_bits: int = 16,
                       adc_clip: float | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sliced associative search over the multi-bit packed AM.

    Args:
      q: (B, D) float32 queries (bipolar on the serving path).
      am_planes_t: (cell_bits, ceil(D/8), C) uint8 offset-code planes.
      offsets: (ceil(D/tile_rows), ceil(C/tile_cols)) float32 per-array
        code-domain readout offsets, or None.
      cell_bits: bits per memory cell (2..8).
      tile_rows / tile_cols: the array geometry (tile_rows a multiple
        of 8).
      adc_bits / adc_clip: ADC resolution and full scale; the clip
        defaults to ``ref.multibit_adc_clip(cell_bits, tile_rows)``.

    Returns:
      (best_idx, best_sim): (B,) int32 and (B,) float32 code-domain
      ADC-quantized similarity.
    """
    if not 2 <= cell_bits <= 8:
        raise ValueError(f"cell_bits={cell_bits} outside [2, 8]")
    if tile_rows % 8:
        raise ValueError(f"tile_rows={tile_rows} not a byte multiple")
    if adc_clip is None:
        adc_clip = ref.multibit_adc_clip(cell_bits, tile_rows)
    b, d = q.shape
    n_planes, dp, c = am_planes_t.shape
    if n_planes != cell_bits:
        raise ValueError(f"{n_planes} planes for cell_bits={cell_bits}")
    if not dp * 8 >= d > (dp - 1) * 8:
        raise ValueError(f"D={d} inconsistent with Dp={dp}")
    check_readout(d, c, tile_rows, tile_cols, adc_bits, adc_clip, offsets)
    if q.device != am_planes_t.device:
        raise ValueError("q and am_planes_t on different devices")
    if q.device.type == "cpu":
        return ref.am_search_multibit(
            q, am_planes_t, cell_bits=cell_bits, tile_rows=tile_rows,
            tile_cols=tile_cols, adc_bits=adc_bits, adc_clip=adc_clip,
            offsets=offsets)
    if q.device.type != "cuda":
        raise ValueError(f"am_search_multibit: unsupported device "
                         f"{q.device}")
    _build.check_operand(q, "q", torch.float32, 2)
    _build.check_operand(am_planes_t, "am_planes_t", torch.uint8, 3)
    if offsets is not None:
        _build.check_operand(offsets, "offsets", torch.float32, 2)
        if offsets.device != q.device:
            raise ValueError("offsets on another device")
    idx = torch.empty((b,), dtype=torch.int32, device=q.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q.device)
    if b == 0:
        return idx, sim
    p = launch_plan(b, d, c, tile_rows)
    scratch = torch.empty((p["scratch_bytes"],), dtype=torch.uint8,
                          device=q.device)
    step = 2.0 * adc_clip / (2 ** adc_bits)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.am_search_multibit_launch(
            q.data_ptr(), am_planes_t.data_ptr(),
            None if offsets is None else offsets.data_ptr(),
            scratch.data_ptr(), p["scratch_bytes"],
            routes(q.device).data_ptr(), idx.data_ptr(), sim.data_ptr(), b,
            d, c, cell_bits, dp, tile_rows, tile_cols, float(adc_clip),
            step, *launch_args(p), _build.stream_of(q))
    _build.check(err, "am_search_multibit")
    am_search_multibit.launches += 1
    return idx, sim


am_search_multibit.launches = 0


def imc_cycles_for(am_planes_t_shape: tuple, tile_rows: int = 128,
                   tile_cols: int = 128) -> int:
    """ceil(Dp*8/rows) * ceil(C/cols) array passes per query: a
    multi-level cell holds the whole code, so the count matches the 1-bit
    search of the same (D, C)."""
    _, dp, c = am_planes_t_shape
    return (-(-dp * 8 // tile_rows)) * (-(-c // tile_cols))
