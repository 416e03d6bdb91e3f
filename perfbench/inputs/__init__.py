"""Makers of a configuration's weights and features, one module each.

A configuration file names its module (``"inputs": "<module>"``); the
module's ``build(cfg, gen)`` returns an ``Inputs``: the (f, D) bipolar
projection, the (C, D) bipolar AM, the (C,) int32 class of each column and
a sampler of feature rows, all made on ``gen``'s device from ``gen``. The
benchmark hands the same ``Inputs`` to the program and to the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class Inputs:
    projection: torch.Tensor      # (f, D) float32 in {-1, +1}
    am: torch.Tensor              # (C, D) float32 in {-1, +1}
    owners: torch.Tensor          # (C,) int32 class of each column
    sample: Callable[[int], torch.Tensor]  # n -> (n, f) float32 rows


def bipolar(gen: torch.Generator, shape) -> torch.Tensor:
    """A float32 {-1, +1} tensor of ``shape`` drawn from ``gen``."""
    bits = torch.randint(0, 2, tuple(shape), generator=gen,
                         device=gen.device)
    return bits.float() * 2.0 - 1.0


def dyadic(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` (|x| <= 1) rounded down to the grid of ``2**-bits``.

    With ``bits`` = 14 and f = 784 features every partial sum of a ±1
    projection is a multiple of 2**-14 below 2**10 in magnitude, so it is
    exact in float32 in any summation order: the program and the
    reference encode the same signs bit for bit, and a TF32 encode, which
    keeps 11 significant bits of each feature, does not.
    """
    scale = float(2 ** bits)
    return torch.floor(x * scale) / scale
