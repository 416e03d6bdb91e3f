"""Host ms a serving call spends in ``kernels/ops.py``'s own code: the self
time of the program's ``ops.*`` spans (tile and tier resolution, the
dispatch counter, the class gather), per serving call in the traced
slice (``program_spans``)."""
from perfbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, program_spans.OPS, own=True)
