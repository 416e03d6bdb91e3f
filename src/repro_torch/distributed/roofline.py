"""Roofline terms from the dry run's counts.

Port of ``repro.distributed.roofline``. Three terms:

  compute    = flops_per_dev / peak_flops
  memory     = bytes_per_dev / hbm_bw
  collective = wire_bytes_per_dev / link_bw

The dominant term approximates the step's time under perfect overlap
(its max lower-bounds it), and model FLOPs / counted FLOPs shows how much
of the counted compute is useful.

The port's default ``HwSpec`` is the NVIDIA H100 SXM5 80GB (H100 80GB
HBM3 at 700 W, NVIDIA's data sheet: dense bfloat16 tensor-core peak,
HBM3 bandwidth, NVLink 4 per direction); it carries no other constant.
``mfu_bound`` divides by the report's own ``hw.peak_flops`` (the
reference divides by its TPU constant whatever ``hw`` was given).
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float        # per chip, bf16
    hbm_bw: float            # B/s per chip
    link_bw: float           # B/s per link
    hbm_bytes: float         # per chip


H100 = HwSpec(name="h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
              link_bw=450e9, hbm_bytes=80e9)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw measurements (per device unless noted)
    flops_per_dev: float
    bytes_per_dev: float
    wire_bytes_per_dev: float
    wire_by_kind: Dict[str, float]
    model_flops_global: float          # 6*N*D (or 6*N_active*D)
    argument_bytes_per_dev: float
    temp_bytes_per_dev: float
    output_bytes_per_dev: float
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    hw: HwSpec = H100

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_seconds(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted = self.flops_per_dev * self.chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization if the step ran at the roofline bound,
        against this report's ``hw``."""
        denom = self.bound_seconds * self.chips
        if denom <= 0:
            return 0.0
        return self.model_flops_global / denom / self.hw.peak_flops

    @property
    def hbm_per_dev(self) -> float:
        return self.argument_bytes_per_dev + self.temp_bytes_per_dev \
            + self.output_bytes_per_dev

    def to_json(self) -> dict:
        """The reference's keys (``hw`` left out)."""
        d = dataclasses.asdict(self)
        del d["hw"]
        d.update(dominant=self.dominant, bound_seconds=self.bound_seconds,
                 useful_flops_ratio=self.useful_flops_ratio,
                 mfu_bound=self.mfu_bound, hbm_per_dev=self.hbm_per_dev)
        return d


def roofline(*, arch: str, shape: str, mesh_name: str, chips: int,
             flops_per_dev: float, bytes_per_dev: float,
             wire_by_kind: Dict[str, float], model_flops_global: float,
             argument_bytes: float = 0.0, temp_bytes: float = 0.0,
             output_bytes: float = 0.0,
             hw: HwSpec = H100) -> RooflineReport:
    wire_total = wire_by_kind.get("total", 0.0)
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=flops_per_dev, bytes_per_dev=bytes_per_dev,
        wire_bytes_per_dev=wire_total, wire_by_kind=dict(wire_by_kind),
        model_flops_global=model_flops_global,
        argument_bytes_per_dev=argument_bytes,
        temp_bytes_per_dev=temp_bytes,
        output_bytes_per_dev=output_bytes,
        hw=hw,
    )
    rep.t_compute = flops_per_dev / hw.peak_flops
    rep.t_memory = bytes_per_dev / hw.hbm_bw
    rep.t_collective = wire_total / hw.link_bw
    return rep


def model_flops(param_count_active: int, tokens: int,
                step: str = "train") -> float:
    """6*N*D for training; 2*N*D for a forward/decode pass."""
    mult = 6.0 if step == "train" else 2.0
    return mult * param_count_active * tokens
