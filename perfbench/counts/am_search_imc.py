"""``am_search_imc``: the tiled analog search with its ADC, float32 cells
(a noisy device instance). Both of the kernel's passes count: the
operand convert pass and the search pass."""
from __future__ import annotations

from perfbench.trace import bound

NAMES = ("search_pass::", "convert_pass")


def ops_bytes(b: int, d: int, c: int, rows: int, cols: int,
              ) -> tuple[int, int]:
    """2 b d c float32 operations; the float32 queries, cells and array
    offsets in, an int32 id and a float32 similarity a row out."""
    arrays = -(-d // rows) * -(-c // cols)
    return 2 * b * d * c, 4 * b * d + 4 * c * d + 4 * arrays + 8 * b


def bound_s(ctx) -> float:
    sim = ctx.config["deploy"]["imc"]["sim"]
    ops, nbytes = ops_bytes(ctx.batch_rows, ctx.config["dim"],
                            ctx.config["columns"], sim["rows"], sim["cols"])
    return ctx.calls * bound(ops, nbytes, ctx.peaks["fp32_flop_per_s"],
                             ctx.peaks)
