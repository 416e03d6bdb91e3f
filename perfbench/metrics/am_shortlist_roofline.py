"""Percent of ``am_shortlist``'s roofline in the traced slice
(``counts/am_shortlist.py``)."""
from perfbench import trace


def read(ctx):
    return trace.roofline(ctx, ctx.module("counts", "am_shortlist"))
