"""Percent of ``encode_pack``'s roofline in the traced slice
(``counts/encode_pack.py``)."""
from perfbench import trace


def read(ctx):
    return trace.roofline(ctx, ctx.module("counts", "encode_pack"))
