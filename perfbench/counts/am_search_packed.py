"""``am_search_packed`` (popcount): the best of C packed columns."""
from __future__ import annotations

from perfbench.trace import bound

NAMES = ("popcount::search",)


def ops_bytes(b: int, d: int, c: int) -> tuple[int, int]:
    """2 b d c one-bit operations (AND or XOR, and the popcount); the
    packed queries and AM in, an int32 id and a float32 similarity a row
    out."""
    dp = -(-d // 8)
    return 2 * b * d * c, b * dp + dp * c + 8 * b


def bound_s(ctx) -> float:
    ops, nbytes = ops_bytes(ctx.batch_rows, ctx.config["dim"],
                            ctx.config["columns"])
    return ctx.calls * bound(ops, nbytes, ctx.peaks["b1_op_per_s"],
                             ctx.peaks)
