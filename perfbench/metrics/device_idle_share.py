"""Percent of the traced slice in which the device ran no operation."""


def read(ctx):
    window = ctx.profile.window_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - ctx.profile.busy_s / window)
