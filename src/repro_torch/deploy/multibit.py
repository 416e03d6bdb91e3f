"""Multi-bit serving artifact: the float AM at 2-8 bits per cell.

Port of ``repro.deploy.multibit``. ``MemhdModel.deploy(target=
"multibit", cell_bits=4)`` freezes a symmetric ``cell_bits``-bit
quantization of the trained float AM shadow (``core.am.quantize_am``)
into offset-code bit planes (``core.am.pack_am_planes``: 8 cells/byte
along D, one plane per bit) and serves every query through the
bit-sliced search (``ops.predict_multibit``: the ``am_search_multibit``
kernel on the GPU) — per-array code-domain partial sums, ADC, digital
accumulation, argmax. C x D x cell_bits resident bits, 16x (2 bits) /
8x (4 bits) below the float32 AM.

An optional ``ImcSimConfig`` sets the array geometry, the ADC and the
per-array readout drift (drawn under the sim seed's drift key, as the
imc backend's). Conductance noise and stuck-at faults are 1-bit storage
perturbations and are refused; ``fit(cell_bits=...)`` trains against the
quantized readout instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.deploy.base import DeployedArtifact
from repro_torch.deploy.registry import register_backend


@dataclasses.dataclass(frozen=True)
class MultibitDeployedMemhd(DeployedArtifact):
    """Frozen MEMHD model resident as plane-packed multi-bit codes."""

    enc_params: Dict[str, torch.Tensor]
    am_planes_t: torch.Tensor             # (cell_bits, ceil(D/8), C) uint8
    am_scale: torch.Tensor                # () float32 quantizer scale
    tile_offsets: Optional[torch.Tensor]  # (gd, gc) readout drift, or None
    centroid_class: torch.Tensor          # (C,) int32
    enc_cfg: Any
    am_cfg: Any
    sim: Optional[Any]                    # ImcSimConfig or None
    cell_bits: int
    sampler: Optional[Any] = dataclasses.field(default=None, compare=False,
                                               repr=False)

    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) classes, through the bit-sliced
        code-domain readout."""
        from repro_torch.kernels import ops
        return ops.predict_multibit(q, self.am_planes_t,
                                    self.centroid_class, sim=self.sim,
                                    offsets=self.tile_offsets)

    def search_query(self, q: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(best_idx, best_sim) with dequantized similarities."""
        from repro_torch.kernels import ops
        return ops.am_search_multibit(q, self.am_planes_t, sim=self.sim,
                                      scale=self.am_scale,
                                      offsets=self.tile_offsets)

    def _deploy_opts(self) -> dict:
        # refresh() re-quantizes the updated float AM at the same bit
        # width onto the same readout (the sim carries the seed).
        return {"cell_bits": self.cell_bits, "sim": self.sim,
                "sampler": self.sampler}

    @property
    def backend(self) -> str:
        return "multibit"

    @property
    def serving_mode(self) -> str:
        return f"bit-sliced-int{self.cell_bits}"

    @property
    def resident_bytes(self) -> int:
        n = self.am_planes_t.numel() + self.am_scale.element_size()
        if self.tile_offsets is not None:
            n += self.tile_offsets.numel() * self.tile_offsets.element_size()
        return int(n)

    @property
    def memory_bits(self) -> int:
        """Table-I accounting at multi-level cells: EM + C*D*cell_bits."""
        return (self.enc_cfg.memory_bits
                + self.am_cfg.am_memory_bits_at(self.cell_bits))

    @property
    def cycles(self) -> int:
        """Array passes per query: a multi-level cell holds the whole
        code, so the grid matches the 1-bit searches' cycle count."""
        from repro_torch.kernels.am_search_multibit import imc_cycles_for
        arr = self._cost_arr()
        return imc_cycles_for(tuple(self.am_planes_t.shape), arr.rows,
                              arr.cols)

    def _cost_arr(self):
        if self.sim is not None:
            return self.sim.arr
        from repro_torch.core.types import ImcArrayConfig
        return ImcArrayConfig()


@register_backend("multibit")
def deploy_multibit(model, cell_bits: int = 4, sim: Optional[Any] = None,
                    *, sampler=None) -> MultibitDeployedMemhd:
    """Quantize ``model``'s float AM shadow to ``cell_bits``-bit planes.
    ``sampler``: where the drift grid comes from (default: the seeded
    generators of ``imcsim.device.draw``)."""
    from repro_torch.core import am as am_lib
    from repro_torch.core import imc as imc_lib
    from repro_torch.imcsim import device as device_lib

    if not 2 <= cell_bits <= 8:
        raise ValueError(
            f"cell_bits={cell_bits} outside [2, 8]; the 1-bit point is "
            "target='packed'")
    offsets = None
    if sim is not None:
        if sim.noise_sigma > 0 or sim.fault_p0 > 0 or sim.fault_p1 > 0:
            raise ValueError(
                "conductance noise / stuck-at faults are 1-bit storage "
                "perturbations; the multibit backend models the readout "
                "path only (drift + ADC)")
        imc_lib.assert_consistent_sim(model.am_cfg.dim,
                                      model.am_cfg.columns, sim.arr)
        offsets = device_lib.draw_drift(sim, model.am_cfg.dim,
                                        model.am_cfg.columns, model.device,
                                        sampler)
    codes, scale = am_lib.quantize_am(model.am_state["fp"], cell_bits)
    return MultibitDeployedMemhd(
        enc_params=model.enc_params,
        am_planes_t=am_lib.pack_am_planes(codes, cell_bits),
        am_scale=scale, tile_offsets=offsets,
        centroid_class=model.am_state["centroid_class"],
        enc_cfg=model.enc_cfg, am_cfg=model.am_cfg, sim=sim,
        cell_bits=cell_bits, sampler=sampler)
