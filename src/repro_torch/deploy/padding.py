"""Shared tile/batch padding utilities (port of ``repro.deploy.padding``).

The row helpers are array-namespace agnostic: numpy in, numpy out (the
serving loop pads on the host, off the device queue) and tensor in,
tensor out (the evaluator and the kernel callers pad device tensors).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def round_up(n: int, tile: int) -> int:
    """Smallest multiple of ``tile`` that is >= ``n``."""
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return -(-n // tile) * tile


def pad_rows(x, n_rows: int, *, fill: str = "zero"):
    """Pad axis 0 of ``x`` up to ``n_rows`` rows.

    fill="zero" appends zero rows (a valid encoder input whose
    prediction the caller discards); fill="edge" repeats the last row
    (the padded-evaluator contract — padded labels are -1, so repeated
    rows can never count as correct).
    """
    pad = n_rows - x.shape[0]
    if pad < 0:
        raise ValueError(f"cannot pad {x.shape[0]} rows down to {n_rows}")
    if pad == 0:
        return x
    shape = (pad,) + tuple(x.shape[1:])
    if fill not in ("zero", "edge"):
        raise ValueError(f"bad fill: {fill!r}")
    if isinstance(x, np.ndarray):
        filler = (np.zeros(shape, x.dtype) if fill == "zero"
                  else np.broadcast_to(x[-1:], shape))
        return np.concatenate([x, filler], axis=0)
    filler = (x.new_zeros(shape) if fill == "zero"
              else x[-1:].expand(shape))
    return torch.cat([x, filler], dim=0)


def pad_to_multiple(x, tile: int) -> Tuple[np.ndarray, int]:
    """Zero-pad rows up to the next multiple of ``tile``.

    Returns (padded, n_valid). Zero feature rows encode to the all-ones
    query (sign(0) -> +1) — a valid input whose prediction is discarded.
    """
    n = int(x.shape[0])
    return pad_rows(x, round_up(max(n, 1), tile)), n


def pad_tiles(x, row_tile: int, col_tile: int | None = None, *, value=0):
    """Constant-pad a rank-2 array so each axis is a tile multiple."""
    r, c = x.shape
    pr = round_up(r, row_tile) - r
    pc = (round_up(c, col_tile) - c) if col_tile else 0
    if not (pr or pc):
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, ((0, pr), (0, pc)), constant_values=value)
    return F.pad(x, (0, pc, 0, pr), value=value)


def pad_vec(x, n: int, *, value=0):
    """Pad a rank-1 array up to ``n`` entries with a constant."""
    pad = n - x.shape[0]
    if pad < 0:
        raise ValueError(f"cannot pad {x.shape[0]} down to {n}")
    if pad == 0:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, (0, pad), constant_values=value)
    return torch.cat([x, x.new_full((pad,), value)])
