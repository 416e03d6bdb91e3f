"""``am_shortlist``: each query's S best of G packed super-centroids."""
from __future__ import annotations

from perfbench.trace import bound

# The tile route's kernel; the stream route's is the top-k kernel of
# packed_topk.cuh, which the hierarchical serving call runs only there.
NAMES = ("tile::search", "packed_topk::topk_kernel")


def ops_bytes(b: int, d: int, g: int, s: int) -> tuple[int, int]:
    """2 b d g one-bit operations; the packed queries and supers in, an
    int32 id and a float32 similarity a shortlisted cluster out."""
    dp = -(-d // 8)
    return 2 * b * d * g, b * dp + dp * g + 8 * b * s


def bound_s(ctx) -> float:
    idx = ctx.config["deploy"]["hierarchical"]
    ops, nbytes = ops_bytes(ctx.batch_rows, ctx.config["dim"],
                            idx["groups"], idx["shortlist"])
    return ctx.calls * bound(ops, nbytes, ctx.peaks["b1_op_per_s"],
                             ctx.peaks)
