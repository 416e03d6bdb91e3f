"""Host ms a serving call spends in the kernels' launchers: the time in
the program's ``launch.*`` spans (operand checks, allocations, the launch
plan, the ctypes launch), per serving call in the traced slice
(``program_spans``)."""
from perfbench import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, program_spans.LAUNCH, own=False)
