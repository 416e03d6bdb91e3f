"""Int8 error-feedback gradient compression.

Port of ``repro.optim.compression``'s local half: ``ef_int8_compress``
quantizes (g + err) into symmetric int8 blocks of 1024 with a float32
scale each and returns the residual to carry into the next step, and
``ef_int8_decompress`` undoes the blocking. The reference's int8 ring
reduce-scatter and all-gather move those payloads over a named mesh axis;
they need the sharding slice (ROADMAP queue 1, item 17c) and raise.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import deferred

_BLOCK = 1024


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (g + err) to int8 blocks; return (q, scale, new_err).

    g, err: same shape, float. q: (nblocks, 1024) int8, scale: (nblocks,
    1) float32, new_err: g's shape, float32.
    """
    x = g.float() + err.float()
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, -flat.shape[0] % _BLOCK)).reshape(-1, _BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(-1)[:flat.shape[0]]
    return q, scale.float(), (flat - deq).reshape(g.shape)


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape,
                       size: int) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:size].reshape(shape)


def ring_reduce_scatter_int8(deq: torch.Tensor, axis_name: str):
    deferred("ring_reduce_scatter_int8 (a mesh axis)", "queue 1 item 17c")


def ring_all_gather(x: torch.Tensor, axis_name: str):
    deferred("ring_all_gather (a mesh axis)", "queue 1 item 17c")
