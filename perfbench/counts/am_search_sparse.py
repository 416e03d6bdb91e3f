"""``am_search_sparse``: the k best member columns of the shortlisted
clusters. The work depends on the data: the members these queries'
clusters hold, as the reference counts them."""
from __future__ import annotations

from perfbench.trace import bound

NAMES = ("tile_topk_kernel",)


def ops_bytes(b: int, d: int, g: int, s: int, k: int, columns: int,
              touched: int) -> tuple[int, int]:
    """2 d one-bit operations a (query, member column) pair, over the
    ``columns`` pairs of a call; in, the ``touched`` distinct member
    columns (packed, with an int32 id each), the packed queries, the
    (b, s) int32 shortlist and the (g,) int32 tile starts and counts; out,
    an int32 id and a float32 similarity a slot."""
    dp = -(-d // 8)
    return (2 * d * columns,
            touched * (dp + 4) + b * dp + 4 * b * s + 8 * g + 8 * b * k)


def bound_s(ctx):
    idx = ctx.config["deploy"]["hierarchical"]
    b, d = ctx.batch_rows, ctx.config["dim"]
    k = ctx.route["kwargs"]["k"]
    total = 0.0
    for work in ctx.works:
        if "columns_touched" not in work:
            return None
        ops, nbytes = ops_bytes(b, d, idx["groups"], idx["shortlist"], k,
                                work["columns"], work["columns_touched"])
        total += bound(ops, nbytes, ctx.peaks["b1_op_per_s"], ctx.peaks)
    return total
