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

A CPU tensor goes through the plain version; a CUDA tensor through the
kernel or raises. ``am_search_multibit.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.am_search_imc import check_readout

# AM columns per tile of the kernel (csrc/sims_argmax.cuh). Its query
# tile is fixed at 64 rows: the reference's autotuned batch tile has no
# counterpart yet (ROADMAP queue 1, item 15).
BN = 64


def am_search_multibit(q: torch.Tensor, am_planes_t: torch.Tensor,
                       offsets: torch.Tensor | None = None, *,
                       cell_bits: int, tile_rows: int = 128,
                       tile_cols: int = 128, adc_bits: int = 16,
                       adc_clip: float | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sliced associative search over the multi-bit packed AM.

    Args:
      q: (B, D) float32 bipolar queries.
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
    n_ct = -(-c // BN)
    part_s = torch.empty((b, n_ct), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, n_ct), dtype=torch.int32, device=q.device)
    step = 2.0 * adc_clip / (2 ** adc_bits)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.am_search_multibit_launch(
            q.data_ptr(), am_planes_t.data_ptr(),
            None if offsets is None else offsets.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, d, c, cell_bits, dp, tile_rows, tile_cols,
            float(adc_clip), step, _build.stream_of(q))
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
