"""Percent of the chip's peak: the least time the model's arithmetic needs
for the rows served in the traced slice (``counts/step_<target>.py``)
over the slice's length."""


def read(ctx):
    counts = ctx.module("counts", f"step_{ctx.route['target']}")
    if counts is None or ctx.rows == 0 or ctx.profile.window_s <= 0:
        return None
    need = counts.seconds(ctx)
    if need is None:
        return None
    return 100.0 * need / ctx.profile.window_s
