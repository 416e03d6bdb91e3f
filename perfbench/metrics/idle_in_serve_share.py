"""Percent of the traced slice in which the device ran no operation while
the program's serving call (an outermost ``serve.*`` span) was open: the
part of ``device_idle_share`` that falls inside the program's own host
work (``program_spans``)."""
from perfbench import program_spans


def read(ctx):
    return program_spans.idle_in_serve_share(ctx)
