"""Simulated-hardware serving artifact: MEMHD on imperfect analog arrays.

Port of ``repro.imcsim.deploy``. ``MemhdModel.deploy(target="imc",
sim=ImcSimConfig(...))`` burns the trained binary AM onto a simulated
device instance — stuck-at faults and conductance variation applied once
(``device.perturb_am``, keyed by ``sim.seed``: the same config always
deploys the same device), per-array drift offsets attached to the
readout — and serves every query through the tiled analog search
(``ops.predict_imc``: the ``am_search_imc`` kernel on the GPU).

With an ideal sim (no perturbations, ADC step <= 1) the predictions
equal the digital model's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core import imc as imc_lib
from repro_torch.core.types import EncoderConfig, ImcSimConfig, MemhdConfig
from repro_torch.deploy.base import DeployedArtifact
from repro_torch.deploy.registry import register_backend
from repro_torch.imcsim import device as device_lib


@dataclasses.dataclass(frozen=True)
class ImcDeployedMemhd(DeployedArtifact):
    """Frozen MEMHD model resident on a simulated analog device."""

    enc_params: Dict[str, torch.Tensor]
    am_analog: torch.Tensor               # (C, D) fault + noise perturbed
    tile_offsets: Optional[torch.Tensor]  # (gd, gc) readout drift, or None
    centroid_class: torch.Tensor          # (C,) int32
    enc_cfg: EncoderConfig
    am_cfg: MemhdConfig
    sim: ImcSimConfig
    # The field sampler the instance was drawn with (None: the seeded
    # generators); refresh() re-burns onto the same instance with it.
    sampler: Optional[device_lib.Sampler] = dataclasses.field(
        default=None, compare=False, repr=False)

    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) classes, through the simulated
        analog readout."""
        from repro_torch.kernels import ops
        return ops.predict_imc(q, self.am_analog, self.centroid_class,
                               sim=self.sim, offsets=self.tile_offsets)

    def refresh(self, model) -> "ImcDeployedMemhd":
        """Re-burn an updated model's binary AM onto the SAME simulated
        device instance (the sim carries the seed)."""
        return deploy_imc(model, self.sim, sampler=self.sampler)

    @property
    def backend(self) -> str:
        return "imc"

    @property
    def serving_mode(self) -> str:
        return "analog"

    @property
    def resident_bytes(self) -> int:
        n = self.am_analog.numel() * self.am_analog.element_size()
        if self.tile_offsets is not None:
            n += self.tile_offsets.numel() * self.tile_offsets.element_size()
        return int(n)

    @property
    def cycles(self) -> int:
        """Array passes per query: the kernel's tile grid, which equals
        ``imc.map_memhd(D, C, arr).cycles`` by construction."""
        from repro_torch.kernels.am_search_imc import imc_cycles_for
        return imc_cycles_for((self.am_cfg.dim, self.am_cfg.columns),
                              self.sim.arr.rows, self.sim.arr.cols)

    def _cost_arr(self):
        return self.sim.arr


@register_backend("imc")
def deploy_imc(model, sim: Optional[ImcSimConfig] = None, *,
               sampler: Optional[device_lib.Sampler] = None,
               ) -> ImcDeployedMemhd:
    """Burn ``model``'s binary AM onto a simulated device instance.

    ``sampler``: where the instance's random fields come from (default:
    the generators keyed by ``sim.seed``, ``device.draw``)."""
    sim = sim or ImcSimConfig()
    imc_lib.assert_consistent_sim(model.am_cfg.dim, model.am_cfg.columns,
                                  sim.arr)
    am_analog, offsets = device_lib.perturb_am(model.am_state["binary"],
                                               sim, sampler)
    return ImcDeployedMemhd(
        enc_params=model.enc_params, am_analog=am_analog,
        tile_offsets=offsets,
        centroid_class=model.am_state["centroid_class"],
        enc_cfg=model.enc_cfg, am_cfg=model.am_cfg, sim=sim,
        sampler=sampler)
