"""The model's arithmetic a row on the packed route: the float32 encode
(2 f D) and the one-bit search of every column (2 D C)."""
from __future__ import annotations


def seconds(ctx) -> float:
    f, d, c = (ctx.config[k] for k in ("features", "dim", "columns"))
    p = ctx.peaks
    return ctx.rows * (2 * f * d / p["fp32_flop_per_s"]
                       + 2 * d * c / p["b1_op_per_s"])
