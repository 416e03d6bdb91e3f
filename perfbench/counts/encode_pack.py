"""``encode_pack``: H = F M in float32, sign, packed 8 bits a byte."""
from __future__ import annotations

from perfbench.trace import bound

NAMES = ("encode_pack_kernel",)


def ops_bytes(b: int, f: int, d: int) -> tuple[int, int]:
    """2 b f d float32 operations; float32 features and projection in,
    the (b, ceil(d / 8)) packed queries out."""
    return 2 * b * f * d, 4 * b * f + 4 * f * d + b * -(-d // 8)


def bound_s(ctx) -> float:
    ops, nbytes = ops_bytes(ctx.batch_rows, ctx.config["features"],
                            ctx.config["dim"])
    return ctx.calls * bound(ops, nbytes, ctx.peaks["fp32_flop_per_s"],
                             ctx.peaks)
