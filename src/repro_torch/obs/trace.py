"""Nested host-side span tracing with Chrome trace-event export.

The port's own copy of ``repro.obs.trace``. ``with span("pad"): ...``
records a complete event ("ph": "X"); spans nest through a thread-local
stack, so every event carries its own ``span_id`` and its enclosing
``parent_id``. The export opens in Perfetto (https://ui.perfetto.dev) or
chrome://tracing.

Clock: a span's start and end are ``time.time_ns()``, Unix-time ns, the
clock ``torch.profiler`` gives its events (its CPU ops are stamped on an
approximate clock converted to Unix time, its CUDA activity likewise).
A span therefore lines up with a kineto trace of the same run: the
Chrome export's ``ts`` with the profiler's, and a reader can clip spans
to a profiled window and lay them over its device ops.

When a span records: while its tracer is ``enabled``, or while a
``torch.profiler`` capture runs on the calling thread
(``torch._C._autograd._profiler_enabled()``, ~0.1-0.2 µs). Otherwise
``span`` returns one shared no-op context manager and ``traced``
calls straight through: that check is all a span costs off (no
generator, no lock, no ``record_function``). The process ``TRACER``
starts disabled (``serve_memhd --trace-out`` enables it); a profiled
slice records its spans without it. A fresh ``Tracer()`` starts enabled.

``span(..., device=True)`` also enters
``torch.profiler.record_function(name)``, only while a capture runs, so
the capture names the CUDA work the span launched. Off a capture it
enters nothing: a ``record_function`` costs ~11 µs with no profiler to
read it.

``traced(name)`` is the decorator form, around the layer boundaries of
the serving routes: ``serve.<method>`` (the artifacts' public serving
methods), ``ops.<op>`` (``kernels/ops.py``) and ``launch.<kernel>`` (the
kernel launchers). It never bridges to ``record_function``, so it adds
no event to a capture. ``annotate(**args)`` adds args to the innermost
open span from inside it (``launch.am_search_packed``'s ``route``).

The recorder is bounded (``max_events``, default 100k): past the cap new
events are counted in ``dropped`` instead of stored.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# True while a torch.profiler (or autograd profiler) capture runs on
# this thread: what record_function itself checks.
capturing = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()


class SpanEvent:
    """One completed span (Chrome "X" event), times in Unix-time ns."""

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


class _Span:
    """One open span: pushed on enter, recorded on exit (also when the
    body raises)."""

    __slots__ = ("tracer", "name", "device", "args", "span_id",
                 "parent_id", "start", "annotation")

    def __init__(self, tracer: "Tracer", name: str, device: bool,
                 args: Optional[dict]):
        self.tracer = tracer
        self.name = name
        self.device = device
        self.args = args

    def __enter__(self):
        tracer = self.tracer
        stack = tracer._stack()
        self.span_id = next(tracer._ids)
        self.parent_id = stack[-1].span_id if stack else 0
        stack.append(self)
        self.annotation = (torch.profiler.record_function(self.name)
                           if self.device and capturing() else None)
        self.start = time.time_ns()
        if self.annotation is not None:
            self.annotation.__enter__()

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        dur = time.time_ns() - self.start
        tracer = self.tracer
        tracer._stack().pop()
        tracer._record(SpanEvent(self.name, self.start, dur, self.span_id,
                                 self.parent_id, threading.get_ident(),
                                 self.args))
        return False


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

    def _stack(self) -> List[_Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _record(self, ev: SpanEvent) -> None:
        with self._lock:
            if len(self._events) < self.max_events:
                self._events.append(ev)
            else:
                self.dropped += 1

    def span(self, name: str, device: bool = False, **args):
        """A context manager that records a nested span around its body
        (the shared no-op where nothing records, module docstring).

        ``args`` become the event's Chrome-trace ``args`` (stringified
        lazily at export). ``device=True`` bridges to
        ``torch.profiler.record_function(name)`` while a capture runs.
        """
        if not (self.enabled or capturing()):
            return _OFF
        return _Span(self, name, device, args or None)

    def traced(self, name: str, batch_arg: Optional[int] = None):
        """Decorator: each call of the function runs inside a span
        ``name``; ``batch_arg``: the position of the argument whose
        length the span records as ``rows``."""
        def wrap(fn):
            @functools.wraps(fn)
            def call(*a, **kw):
                if not (self.enabled or capturing()):
                    return fn(*a, **kw)
                args = (None if batch_arg is None or len(a) <= batch_arg
                        else {"rows": len(a[batch_arg])})
                with _Span(self, name, False, args):
                    return fn(*a, **kw)
            return call
        return wrap

    def current_span_id(self) -> int:
        """Id of the innermost open span on this thread (0 = none)."""
        stack = self._stack()
        return stack[-1].span_id if stack else 0

    def annotate(self, **args) -> None:
        """Add ``args`` to the innermost open span of this thread, for
        what a function learns inside its ``traced`` span (a launcher's
        route); nothing where nothing records or no span is open."""
        if not (self.enabled or capturing()):
            return
        stack = self._stack()
        if stack:
            top = stack[-1]
            top.args = {**(top.args or {}), **args}

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


# Process-default tracer, off until an entry point enables it; ``span``
# and ``traced`` are what call sites use.
TRACER = Tracer()
TRACER.enabled = False
span = TRACER.span
traced = TRACER.traced
annotate = TRACER.annotate
export_chrome_trace = TRACER.export
