"""Nested host-side span tracing with Chrome trace-event export.

The port's own copy of ``repro.obs.trace``. ``with span("pad"): ...``
records a complete event ("ph": "X") with ``perf_counter_ns``
timestamps; spans nest through a thread-local stack, so every event
carries its own ``span_id`` and its enclosing ``parent_id``. The export
opens in Perfetto (https://ui.perfetto.dev) or chrome://tracing.

``span(..., device=True)`` also wraps the body in
``torch.profiler.record_function(name)``, so under a ``torch.profiler``
capture the host span names the CUDA work it launched; off the profiler
it costs little.

The recorder is bounded (``max_events``, default 100k): past the cap new
events are counted in ``dropped`` instead of stored.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class SpanEvent:
    """One completed span (Chrome "X" event), times in ns."""

    __slots__ = ("name", "start_ns", "dur_ns", "span_id", "parent_id",
                 "tid", "args")

    def __init__(self, name, start_ns, dur_ns, span_id, parent_id, tid,
                 args):
        self.name = name
        self.start_ns = start_ns
        self.dur_ns = dur_ns
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.args = args


class Tracer:
    """Span recorder; one per process is plenty (module ``TRACER``)."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = max_events
        self._lock = threading.Lock()
        self._events: List[SpanEvent] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self.dropped = 0
        self.enabled = True

    # -- recording ----------------------------------------------------

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextmanager
    def span(self, name: str, device: bool = False, **args):
        """Record a nested span around the body.

        ``args`` become the event's Chrome-trace ``args`` (stringified
        lazily at export). ``device=True`` bridges to
        ``torch.profiler.record_function(name)`` so host spans name the
        CUDA activity they launched under a ``torch.profiler`` capture.
        """
        if not self.enabled:
            yield
            return
        stack = self._stack()
        span_id = next(self._ids)
        parent_id = stack[-1] if stack else 0
        stack.append(span_id)
        annotation = _device_annotation(name) if device else None
        start = time.perf_counter_ns()
        try:
            if annotation is not None:
                with annotation:
                    yield
            else:
                yield
        finally:
            dur = time.perf_counter_ns() - start
            stack.pop()
            ev = SpanEvent(name, start, dur, span_id, parent_id,
                           threading.get_ident(), args or None)
            with self._lock:
                if len(self._events) < self.max_events:
                    self._events.append(ev)
                else:
                    self.dropped += 1

    def current_span_id(self) -> int:
        """Id of the innermost open span on this thread (0 = none)."""
        stack = self._stack()
        return stack[-1] if stack else 0

    # -- export -------------------------------------------------------

    def events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome_trace(self) -> Dict:
        """The Chrome trace-event JSON object (trace-viewer / Perfetto).

        Timestamps and durations are microseconds (floats are legal);
        thread ids are compacted to small ints in first-seen order so
        the viewer's track names stay readable.
        """
        pid = os.getpid()
        tids: Dict[int, int] = {}
        trace_events: List[Dict] = []
        for ev in self.events():
            tid = tids.setdefault(ev.tid, len(tids))
            args = {"span_id": ev.span_id, "parent_id": ev.parent_id}
            if ev.args:
                args.update({k: _jsonable(v) for k, v in ev.args.items()})
            trace_events.append({
                "name": ev.name,
                "ph": "X",
                "ts": ev.start_ns / 1e3,
                "dur": ev.dur_ns / 1e3,
                "pid": pid,
                "tid": tid,
                "args": args,
            })
        meta = {"dropped_events": self.dropped}
        return {"traceEvents": trace_events, "displayTimeUnit": "ms",
                "otherData": meta}

    def export(self, path: str) -> str:
        """Write the Chrome trace JSON; returns the path."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path


def _jsonable(v):
    return v if isinstance(v, (int, float, bool, str, type(None))) else str(v)


def _device_annotation(name: str):
    """``torch.profiler.record_function(name)``."""
    import torch.profiler
    return torch.profiler.record_function(name)


# Process-default tracer; ``span`` is the one-liner call sites use.
TRACER = Tracer()
span = TRACER.span
export_chrome_trace = TRACER.export
