"""The closed loop's ``batch_p95_ms`` over the whole window of a traced
run: the 95th percentile of dispatch to answers on the host, its last
seconds under the profiler. At a fixed depth a batch's wait follows the
loop's rate, so this reads the host's hiccups in the tail."""


def read(ctx):
    return ctx.readings.get("batch_p95_ms")
