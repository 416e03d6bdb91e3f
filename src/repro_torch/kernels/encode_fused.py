"""Fused feature -> packed-query encoding: projection MVM + sign + bitpack.

Port of ``repro.kernels.encode_fused`` (``csrc/encode_pack.cu``). The
only thing the packed search reads is one bit per dimension (H >= 0), so
the kernel keeps the float hypervector H in registers and writes the
packed query rows directly. ``search_from_features`` and
``predict_from_features`` chain it straight into ``am_search_packed``:
the only intermediate is the (B, ceil(D/8)) packed query tensor.

A CPU tensor is encoded by the plain version (``ref.encode_pack``); a
CUDA tensor goes through the kernel or raises. ``encode_pack.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.am_search_packed import (
    DEFAULT_BLOCK_B, am_search_packed,
)
from repro_torch.kernels.binary_mvm import SGEMM_TILE, SGEMM_TILES
from repro_torch.kernels.binary_mvm import imc_cycles_for as _mvm_cycles
from repro_torch.obs.trace import traced

# The rows of the kernel's block tile: its only query tile (the
# reference's autotuned batch tile has no other counterpart here).
BLOCK_B_CHOICES = (SGEMM_TILES[SGEMM_TILE][0],)


def imc_cycles_for(feats_shape: tuple, projection_shape: tuple) -> int:
    """ceil(f/128) * ceil(D/128): the reference's
    ``encode_fused.imc_cycles_for``, ``binary_mvm``'s count (the pack
    epilogue adds no cycle), equal to ``core.imc.map_basic(f, D).cycles``.
    """
    return _mvm_cycles(feats_shape, projection_shape)


def encode_pack(feats: torch.Tensor, projection: torch.Tensor,
                ) -> torch.Tensor:
    """(B, f) float32 features, (f, D) float32 bipolar projection ->
    (B, ceil(D/8)) uint8, bit 1 iff feats @ projection >= 0, LSB-first
    along D with tail bits 0 — ``pack_rows(binarize_query(H))``."""
    return encode_pack_tiled(feats, projection, SGEMM_TILE)


@traced("launch.encode_pack")
def encode_pack_tiled(feats: torch.Tensor, projection: torch.Tensor,
                      tile: int) -> torch.Tensor:
    """``encode_pack`` through block tile ``binary_mvm.SGEMM_TILES[tile]``
    (the tile sweep's entry; counted as a launch of ``encode_pack``)."""
    b, f = feats.shape
    f2, d = projection.shape
    if f != f2:
        raise ValueError(f"feature widths differ: {tuple(feats.shape)} "
                         f"vs {tuple(projection.shape)}")
    if feats.device != projection.device:
        raise ValueError("feats and projection on different devices")
    if feats.device.type == "cpu":
        return ref.encode_pack(feats, projection)
    if feats.device.type != "cuda":
        raise ValueError(f"encode_pack: unsupported device {feats.device}")
    _build.check_operand(feats, "feats", torch.float32, 2)
    _build.check_operand(projection, "projection", torch.float32, 2)
    out = torch.empty((b, -(-d // 8)), dtype=torch.uint8,
                      device=feats.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(feats.device):
        err = lib.encode_pack_launch(feats.data_ptr(),
                                     projection.data_ptr(), out.data_ptr(),
                                     b, f, d, tile,
                                     _build.stream_of(feats))
    _build.check(err, "encode_pack")
    encode_pack.launches += 1
    encode_pack.tile_launches[tile] = encode_pack.tile_launches.get(tile,
                                                                    0) + 1
    return out


encode_pack.launches = 0
encode_pack.tile_launches = {}  # SGEMM_TILES index -> launches


def search_from_features(feats: torch.Tensor, projection: torch.Tensor,
                         am_packed_t: torch.Tensor, *,
                         mode: str = "popcount",
                         block_b: int | None = DEFAULT_BLOCK_B,
                         tile: int = SGEMM_TILE,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """encode_pack |> am_search_packed: (best_idx, best_sim) bit-exact
    with the staged encode_query -> pack_rows -> am_search_packed chain.
    ``tile``: the encode's block tile, ``block_b`` the search's."""
    qp = encode_pack_tiled(feats, projection, tile)
    return am_search_packed(qp, am_packed_t, n_dims=projection.shape[1],
                            mode=mode, block_b=block_b)


def predict_from_features(feats: torch.Tensor, projection: torch.Tensor,
                          am_packed_t: torch.Tensor,
                          centroid_class: torch.Tensor, *,
                          mode: str = "popcount",
                          block_b: int | None = DEFAULT_BLOCK_B,
                          tile: int = SGEMM_TILE,
                          ) -> torch.Tensor:
    """encode_pack |> am_search_packed |> ownership gather: (B,) classes."""
    idx, _ = search_from_features(feats, projection, am_packed_t,
                                  mode=mode, block_b=block_b, tile=tile)
    return centroid_class[idx.long()]
