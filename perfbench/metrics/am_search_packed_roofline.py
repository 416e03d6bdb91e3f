"""Percent of ``am_search_packed``'s roofline in the traced slice
(``counts/am_search_packed.py``)."""
from perfbench import trace


def read(ctx):
    return trace.roofline(ctx, ctx.module("counts", "am_search_packed"))
