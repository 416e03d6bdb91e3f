"""Device-fidelity associative search: tiled analog MVM + per-array ADC.

Port of ``repro.kernels.am_search_imc`` (``csrc/am_search_imc.cu``). A
real IMC deployment computes the search through physics: the (D x C) AM
is cut into (tile_rows x tile_cols) arrays, each array's analog partial
sum picks up its readout offset and goes through a finite-resolution
ADC, and only the quantized tile outputs are accumulated and compared.
With an ideal sim (>= 8-bit ADC at 128-row arrays, no perturbations) the
result equals the exact ``am_search`` bit for bit.

Conductance noise and stuck-at faults are storage perturbations: they
are burned into the AM before it reaches the kernel
(``repro_torch.imcsim.device``); the kernel models the readout (tiling,
offsets, ADC).

The kernel picks its route on the device, per call: when q and the AM
view are integers in [-127, 127] and every slab partial is exact
(``int8_route``: ±1 queries against an ideal ±1 AM) the products run on
the int8 tensor cores; otherwise (a noisy float AM) in true fp32 FMAs,
each slab summed in the plain version's order. ``route_counts()`` reads
how many calls took each route (one device sync); ``reset_routes()``
zeroes them. ``launch_plan`` is the kernel's grid, slab walk, shared
memory and scratch, handed to the launcher, which refuses any other.

A CPU tensor goes through the plain version (``ref.am_search_imc``); a
CUDA tensor through the kernel or raises. ``am_search_imc.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._search_pass import (  # noqa: F401
    BLOCK_ROWS, FP32_STEP, SMEM, int8_route, launch_args, search_plan,
)
from repro_torch.obs.trace import traced

ROUTES = _build.RouteCounts.NAMES
_ROUTES = _build.RouteCounts()


def launch_plan(b: int, d: int, c: int, tile_rows: int) -> dict:
    """``am_search_imc``'s launch for B queries against a (D, C) AM
    (``csrc/search_pass.cuh``, cut into ``tile_rows`` slabs)."""
    return search_plan(b, d, c, tile_rows)


def routes(device: torch.device) -> torch.Tensor:
    """The (2,) int32 device counter of calls per route on ``device``."""
    return _ROUTES.tensor(device)


def route_counts() -> dict[str, int]:
    """Calls per route since the last reset, over all devices."""
    return _ROUTES.counts()


def reset_routes() -> None:
    _ROUTES.reset()


def _grid(d: int, c: int, tile_rows: int, tile_cols: int) -> tuple:
    return -(-d // tile_rows), -(-c // tile_cols)


def check_readout(d: int, c: int, tile_rows: int, tile_cols: int,
                  adc_bits: int, adc_clip: float, offsets) -> None:
    """Refuse a geometry or ADC the kernels do not take."""
    if tile_rows < 1 or tile_cols < 1:
        raise ValueError(f"array geometry {tile_rows}x{tile_cols} must be "
                         "positive")
    if adc_bits < 1 or not adc_clip > 0:
        raise ValueError(f"ADC needs bits >= 1 and clip > 0, got "
                         f"{adc_bits} bits, clip {adc_clip}")
    if d == 0 or c == 0:
        raise ValueError("the AM has no dims or no columns")
    grid = _grid(d, c, tile_rows, tile_cols)
    if offsets is not None and tuple(offsets.shape) != grid:
        raise ValueError(f"offsets shape {tuple(offsets.shape)} != tile "
                         f"grid {grid}")


@traced("launch.am_search_imc")
def am_search_imc(q: torch.Tensor, am_t: torch.Tensor,
                  offsets: torch.Tensor | None = None, *,
                  tile_rows: int = 128, tile_cols: int = 128,
                  adc_bits: int = 16, adc_clip: float = 128.0,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Associative search as the tiled analog arrays compute it.

    Args:
      q: (B, D) float32 queries.
      am_t: (D, C) float32 transposed resident AM (typically the
        perturbed device instance), any strides.
      offsets: (ceil(D/tile_rows), ceil(C/tile_cols)) float32 per-array
        readout offsets, or None.
      tile_rows / tile_cols: the array geometry.
      adc_bits / adc_clip: ADC resolution and full-scale range.

    Returns:
      (best_idx, best_sim): (B,) int32 winning centroid (first wins ties)
      and (B,) float32 its ADC-quantized accumulated similarity.
    """
    b, d = q.shape
    d2, c = am_t.shape
    if d != d2:
        raise ValueError(f"widths differ: {tuple(q.shape)} vs "
                         f"{tuple(am_t.shape)}")
    check_readout(d, c, tile_rows, tile_cols, adc_bits, adc_clip, offsets)
    if q.device != am_t.device:
        raise ValueError("q and am_t on different devices")
    if q.device.type == "cpu":
        return ref.am_search_imc(q, am_t, tile_rows=tile_rows,
                                 tile_cols=tile_cols, adc_bits=adc_bits,
                                 adc_clip=adc_clip, offsets=offsets)
    if q.device.type != "cuda":
        raise ValueError(f"am_search_imc: unsupported device {q.device}")
    _build.check_operand(q, "q", torch.float32, 2)
    _build.check_operand(am_t, "am_t", torch.float32, 2, contiguous=False)
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
        err = lib.am_search_imc_launch(
            q.data_ptr(), am_t.data_ptr(), am_t.stride(0), am_t.stride(1),
            None if offsets is None else offsets.data_ptr(),
            scratch.data_ptr(), p["scratch_bytes"],
            routes(q.device).data_ptr(), idx.data_ptr(), sim.data_ptr(), b,
            d, c, tile_rows, tile_cols, float(adc_clip), step,
            *launch_args(p), _build.stream_of(q))
    _build.check(err, "am_search_imc")
    am_search_imc.launches += 1
    return idx, sim


am_search_imc.launches = 0


def imc_cycles_for(am_t_shape: tuple, tile_rows: int = 128,
                   tile_cols: int = 128) -> int:
    """ceil(D/rows) * ceil(C/cols) array passes per query — equal to
    ``core.imc.map_memhd(D, C, arr).cycles`` for that geometry."""
    d, c = am_t_shape
    return (-(-d // tile_rows)) * (-(-c // tile_cols))
