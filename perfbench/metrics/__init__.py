"""Per-layer metric readers, one module a metric of ``BENCHMARK.json``.

``metrics/<name>.py`` defines ``read(ctx)``: the metric's value from a
traced slice (``trace.Context``), or None where the slice holds nothing
to read, and the harness then leaves the metric out of the line. A share
of a roofline or of a peak is never reported as 0 for want of a reading.
"""
