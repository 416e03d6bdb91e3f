"""Host ms a serving call spends in the artifact's own code: the self time
of the program's ``serve.*`` spans (its checks, the staged encode, the
class gather), summed over the traced slice and divided by its serving
calls (``program_spans``)."""
from perfbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, program_spans.SERVE, own=True)
