"""The model's arithmetic a row on the simulated analog route: the
float32 encode (2 f D) and the float32 search of every column (2 D C)."""
from __future__ import annotations


def seconds(ctx) -> float:
    f, d, c = (ctx.config[k] for k in ("features", "dim", "columns"))
    return ctx.rows * (2 * f * d + 2 * d * c) / ctx.peaks["fp32_flop_per_s"]
