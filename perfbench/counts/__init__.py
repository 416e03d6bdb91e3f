"""Operations and bytes of each kernel, from the model's maths.

``counts/<kernel>.py`` gives ``NAMES``, substrings of the kernel's device
op names in a trace, ``ops_bytes(...)`` for one call from its shapes (and,
where the work depends on the data, from what the reference says these
rows need), and ``bound_s(ctx)``, the least seconds its calls in a traced
slice need at the peaks of ``peaks.json``: the larger of the operations
at the rate of the number format the model states and each input byte
read once and each output byte written once at the memory bandwidth,
whatever route the kernel takes. ``counts/step_<target>.py`` gives the
least seconds of the whole model's arithmetic for a route's rows.
"""
