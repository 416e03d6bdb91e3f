"""Host ms to enqueue one batch: the benchmark's span around the call into
the artifact, summed over the window's untraced calls and divided by
their number."""


def read(ctx):
    if ctx.dispatch_calls == 0:
        return None
    return 1e3 * ctx.dispatch_s / ctx.dispatch_calls
