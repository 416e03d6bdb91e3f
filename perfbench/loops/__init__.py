"""Loops that serve a traffic mix, one module a ``kind`` of mix.

``loops/<kind>.py`` defines ``run(call, pool, mix, seconds, on_back,
like, *, trace_seconds)`` and returns a ``generator.Window`` whose
``readings`` hold the end-to-end metrics it measured, by name.
"""
