"""Learning-rate schedules (pure functions of the step counter).

Port of ``repro.optim.schedule``: ``make_schedule(cfg)`` returns step ->
lr multiplier in [min_ratio, 1], a float32 scalar tensor computed with
the reference's float32 arithmetic.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"        # "cosine" | "linear" | "constant"
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_ratio: float = 0.1      # floor as a fraction of peak lr

    def __post_init__(self):
        if self.kind not in ("cosine", "linear", "constant"):
            raise ValueError(f"bad schedule kind {self.kind!r}")
        if self.warmup_steps < 0 or self.total_steps <= 0:
            raise ValueError("bad schedule steps")


def make_schedule(cfg: ScheduleConfig):
    """Returns step -> lr multiplier in [min_ratio, 1] (a 0-dim float32
    tensor on the step's device; an int step gives a CPU tensor)."""

    def fn(step) -> torch.Tensor:
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
        if cfg.kind == "constant":
            decay = 1.0
        else:
            frac = torch.clamp(
                (s - cfg.warmup_steps)
                / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
            if cfg.kind == "cosine":
                decay = 0.5 * (1 + torch.cos(math.pi * frac))
            else:  # linear
                decay = 1.0 - frac
        mult = cfg.min_ratio + (1 - cfg.min_ratio) * decay
        return warm * mult

    return fn
