"""``closed_bulk``: a closed loop over a device-resident pool of rows.

The pool of ``pool_rows`` input rows (a row is one input of the cell's
call: a feature row for MEMHD, for a language model one sequence at the
lengths its traffic file states) is cut into batches of ``batch_rows``
taken in order (batch i is pool slot i mod pool_rows / batch_rows, so
every seed serves the same sizes in the same order), with up to
``in_flight`` batches dispatched and not yet back. Each batch's
answers are copied to pinned host memory behind its call and a CUDA event
is recorded behind the copy; the oldest batch is drained on its event
before the next is dispatched.

Readings: ``rows_per_s``, the rows whose answers reached the host over
the window (first dispatch to the last answer back), and
``batch_p95_ms``, the 95th percentile over every batch of the time from
its dispatch to its answers on the host.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable

import numpy as np
import torch

from perfbench import generator, trace


def run(call: Callable, pool: torch.Tensor, mix: dict, seconds: float,
        on_back: Callable, like: tuple, *,
        trace_seconds: float = 0.0) -> generator.Window:
    """Run the closed loop for ``seconds``; ``on_back(slot, outputs)``
    gets each batch's answers on the host, oldest first; ``like`` is a
    call's output tuple, which the host buffers copy in shape and type.
    With ``trace_seconds`` the last that many seconds run under the
    profiler, after the batches before them are drained."""
    rows, depth = mix["batch_rows"], mix["in_flight"]
    n_slots = pool.shape[0] // rows
    cuda = pool.device.type == "cuda"
    ring = [([torch.empty(o.shape, dtype=o.dtype, pin_memory=cuda)
              for o in like],
             torch.cuda.Event() if cuda else generator.HostEvent())
            for _ in range(depth)]
    if trace_seconds > 0:
        trace.warm_up()
    pending = collections.deque()
    lat, back, disp_s, disp_n, traced = [], 0, 0.0, 0, []
    prof = window_span = None
    t0 = time.perf_counter()
    t_end, t_last = t0 + seconds, t0
    t_trace = t_end - trace_seconds if trace_seconds > 0 else float("inf")

    def span(name):
        if prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(trace.SPAN + name)

    def drain_one():
        nonlocal back, t_last
        ts, slot, ev, host = pending.popleft()
        with span("wait"):
            ev.synchronize()
        t_last = time.perf_counter()
        lat.append(t_last - ts)
        with span("check"):
            on_back(slot, host)
        back += rows

    i = 0
    while True:
        now = time.perf_counter()
        if prof is None and now >= t_trace:
            while pending:
                drain_one()
            prof = trace.start()
            window_span = torch.profiler.record_function(
                trace.SPAN + trace.WINDOW)
            window_span.__enter__()
        if now >= t_end:
            break
        if len(pending) == depth:
            drain_one()
        slot = i % n_slots
        with span("dispatch"):
            ts = time.perf_counter()
            outs = call(pool[slot * rows:(slot + 1) * rows])
            td = time.perf_counter()
        if prof is None:
            disp_s += td - ts
            disp_n += 1
        else:
            traced.append(slot)
        host, ev = ring[i % depth]
        with span("copy"):
            for h, o in zip(host, outs):
                h.copy_(o, non_blocking=cuda)
            ev.record()
        pending.append((ts, slot, ev, host))
        i += 1
    while pending:
        drain_one()
    profile = None
    if prof is not None:
        window_span.__exit__(None, None, None)
        profile = trace.stop(prof)
    length = t_last - t0
    readings = {"rows_per_s": back / length,
                "batch_p95_ms": 1e3 * float(np.percentile(lat, 95))}
    return generator.Window(length, i, i * rows, back, readings, disp_s,
                            disp_n, traced, profile)
