"""The model's arithmetic on the coarse-to-fine route: the float32 encode
(2 f D a row), the one-bit scores of the G supers (2 D G a row) and of
the member columns of each row's shortlisted clusters (2 D a column, as
the reference counts them)."""
from __future__ import annotations


def seconds(ctx):
    f, d = ctx.config["features"], ctx.config["dim"]
    g = ctx.config["deploy"]["hierarchical"]["groups"]
    if any("columns" not in w for w in ctx.works):
        return None
    columns = sum(w["columns"] for w in ctx.works)
    p = ctx.peaks
    return (ctx.rows * (2 * f * d / p["fp32_flop_per_s"]
                        + 2 * d * g / p["b1_op_per_s"])
            + 2 * d * columns / p["b1_op_per_s"])
