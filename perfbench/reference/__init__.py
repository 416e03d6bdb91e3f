"""Plain PyTorch reference of the served answers, one module a deploy target.

``reference/<target>.py`` holds the semantics of the program's artifact
of that target, written from the model's definition: ``prepare(inputs,
opts, seed)`` works out again what the program's deploy derives from the
benchmark's inputs (a device instance, a cluster layout), and
``answers(state, rows, route, lower)`` returns, for a block of input
rows, the tuple the route's call returns, plus a dict of what these rows
need of each kernel (read by ``counts/``). It may define ``rows_differ(got,
want)``, the rows of one answer (numpy arrays) that it does not accept;
without it the harness holds every answer to exact equality. Nothing here
imports ``repro_torch`` or the JAX package.

``lower=True`` is the control: the same answers one precision below the
one the configuration states. The MEMHD configurations state float32
with TF32 off, so theirs has the float32 products in TF32 (on the CPU,
which has no TF32, the operands of each product are rounded to TF32's
10-bit mantissa, to nearest even).
"""
from __future__ import annotations

import contextlib

import torch

NEG = float(torch.finfo(torch.float32).min)  # an exhausted top-k slot


@contextlib.contextmanager
def precision(lower: bool):
    """Float32 products in full precision, or in TF32, one precision
    lower, for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = lower
    torch.backends.cudnn.allow_tf32 = lower
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, nearest even)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, lower: bool) -> torch.Tensor:
    """``a @ b`` in float32, or in TF32 for the control."""
    if lower and a.device.type == "cpu":
        a, b = round_tf32(a), round_tf32(b)
    with precision(lower):
        return a @ b


def queries(feats: torch.Tensor, projection: torch.Tensor,
            lower: bool = False) -> torch.Tensor:
    """The projection encoder: sign(feats @ projection), sign(0) = +1,
    as float32 {-1, +1} rows."""
    h = matmul(feats.float(), projection, lower)
    return torch.where(h >= 0, 1.0, -1.0)


def top_by_key(sims: torch.Tensor, valid: torch.Tensor, k: int,
               dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k best columns of each row by (-sim, column id) among the
    ``valid`` ones: ((B, k) int32 ids, (B, k) float32 sims), an exhausted
    slot (-1, NEG). ``sims`` are integers in [-dim, dim]."""
    n = sims.shape[-1]
    span = 1 << n.bit_length()
    ids = torch.arange(n, device=sims.device)
    key = (sims.long() + dim) * span + (span - 1 - ids)
    key = torch.where(valid, key, -1)
    top = torch.topk(key, min(k, n), dim=-1).values
    hit = top >= 0
    idx = torch.where(hit, span - 1 - top % span, -1).to(torch.int32)
    best = torch.where(hit, (top // span - dim).float(),
                       torch.tensor(NEG, device=sims.device))
    if k > n:
        pad = k - n
        idx = torch.nn.functional.pad(idx, (0, pad), value=-1)
        best = torch.nn.functional.pad(best, (0, pad), value=NEG)
    return idx, best
