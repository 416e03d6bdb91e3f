"""Int8 error-feedback gradient compression for the cross-pod reduction.

Port of ``repro.optim.compression``. ``ef_int8_compress`` quantizes
(g + err) into symmetric int8 blocks of 1024 with a float32 scale each
and returns the residual to carry into the next step;
``ef_int8_decompress`` undoes the blocking. ``ring_reduce_scatter_int8``
and ``ring_all_gather`` move those payloads around a ring over one named
mesh axis with the reference's hop schedule, each hop a
``collectives.permute`` (so the recorder logs every hop): the reduce leg
carries int8 rows and float32 scales (a quarter of a float32 ring's
bytes), the all-gather leg float32. Each takes one tensor per member of
the axis (a 1-D mesh, ``Mesh.axis_mesh``) and returns one per member, on
that member's device.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives

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


def _requantize(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 wire format for a (chunk, _BLOCK) partial sum."""
    s = buf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(buf / s), -127, 127).to(torch.int8)
    return q, s.float()


def _ring(n: int) -> List[Tuple[int, int]]:
    return [(j, (j + 1) % n) for j in range(n)]


def ring_reduce_scatter_int8(parts: Sequence[torch.Tensor], mesh,
                             axis: str) -> List[torch.Tensor]:
    """Ring reduce-scatter over ``axis`` with an int8 wire format.

    parts[j]: member j's (nblocks, _BLOCK) float32 gradient blocks;
    nblocks must divide by the axis size n. At hop t (n - 1 hops) member
    j sends its running partial of chunk (j - t) mod n, re-quantized to
    int8 with per-row float32 scales, and folds the incoming one into its
    own copy of chunk (j - t - 1) mod n. Member j leaves holding the
    fully reduced chunk (j + 1) mod n: (nblocks / n, _BLOCK) float32.
    """
    n = mesh.shape[axis]
    nb = parts[0].shape[0]
    if nb % n:
        raise ValueError(f"nblocks={nb} not divisible by axis size {n}")
    chunks = [p.reshape(n, nb // n, _BLOCK) for p in parts]
    buf = [c[j] for j, c in enumerate(chunks)]
    for t in range(n - 1):
        qs = [_requantize(b) for b in buf]
        qr = collectives.permute([q for q, _ in qs], mesh, axis, _ring(n))
        sr = collectives.permute([s for _, s in qs], mesh, axis, _ring(n))
        buf = [q.float() * s + chunks[j][(j - t - 1) % n]
               for j, (q, s) in enumerate(zip(qr, sr))]
    return buf


def ring_all_gather(parts: Sequence[torch.Tensor], mesh,
                    axis: str) -> List[torch.Tensor]:
    """Ring all-gather of the per-member chunks back to the whole array:
    member j enters holding chunk (j + 1) mod n and leaves holding all n
    in order, concatenated along axis 0; the payload stays float32 (the
    reduced gradient must be exact)."""
    n = mesh.shape[axis]
    outs, cur = [], list(parts)
    for j, x in enumerate(parts):
        out = x.new_zeros((n,) + tuple(x.shape))
        out[(j + 1) % n] = x
        outs.append(out)
    for hop in range(1, n):
        cur = collectives.permute(cur, mesh, axis, _ring(n))
        for j, x in enumerate(cur):
            outs[j][(j + 1 - hop) % n] = x
    return [o.reshape((n * o.shape[1],) + tuple(o.shape[2:])) for o in outs]
