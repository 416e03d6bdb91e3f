"""The program's own spans in a traced slice, for the per-layer readers.

The port records a span at each layer boundary of its serving routes
(``repro_torch.obs.trace``): ``serve.<method>`` around an artifact's
serving call, ``ops.<op>`` around a dispatch of ``kernels/ops.py``,
``launch.<kernel>`` around a kernel's launcher. Its tracer records them
while a profiler capture runs, so a ``--trace 1`` run's slice holds
them, stamped on the profiler's Unix-time clock. This module takes
``TRACER.events()``, keeps the spans that overlap the slice's window
(``ctx.profile.window``), clipped to it, and computes:

- a span's self time: its duration minus the part its child spans cover;
- a serving call: an outermost ``serve.*`` span, one with no ``serve.*``
  span above it (the staged route's ``serve.predict_features`` encloses
  ``serve.predict``).

A program without these spans (or whose spans lie on another clock)
gives no serving call, and every reading is None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SERVE, OPS, LAUNCH = "serve.", "ops.", "launch."


@dataclasses.dataclass
class Span:
    """One program span clipped to the window; times in ns."""

    name: str
    start: int
    end: int
    span_id: int
    parent_id: int


def spans(ctx, events=None) -> list:
    """The program's spans (``events``, default its process tracer's)
    that overlap the slice's window, clipped to it."""
    if events is None:
        from repro_torch.obs import trace as program_trace
        events = program_trace.TRACER.events()
    w0, w1 = (round(t * 1e9) for t in ctx.profile.window)
    out = []
    for ev in events:
        start, end = ev.start_ns, ev.start_ns + ev.dur_ns
        if end > w0 and start < w1:
            out.append(Span(ev.name, max(start, w0), min(end, w1),
                            ev.span_id, ev.parent_id))
    return out


class Slice:
    """The clipped spans of one slice, linked by their parent ids."""

    def __init__(self, spans: list):
        self.spans = spans
        self.by_id = {sp.span_id: sp for sp in spans}
        self.children_ns = {}
        for sp in spans:
            if sp.parent_id in self.by_id:
                self.children_ns[sp.parent_id] = (
                    self.children_ns.get(sp.parent_id, 0)
                    + sp.end - sp.start)

    def has_ancestor(self, sp: Span, prefix: str) -> bool:
        p = self.by_id.get(sp.parent_id)
        while p is not None:
            if p.name.startswith(prefix):
                return True
            p = self.by_id.get(p.parent_id)
        return False

    def outermost(self, prefix: str) -> list:
        """The ``prefix`` spans with no ``prefix`` span above them."""
        return [sp for sp in self.spans if sp.name.startswith(prefix)
                and not self.has_ancestor(sp, prefix)]

    def self_ns(self, prefix: str) -> int:
        """Self time of the ``prefix`` spans, summed."""
        return sum(sp.end - sp.start - self.children_ns.get(sp.span_id, 0)
                   for sp in self.spans if sp.name.startswith(prefix))

    def time_ns(self, prefix: str) -> int:
        """Time inside ``prefix`` spans: the outermost ones' durations."""
        return sum(sp.end - sp.start for sp in self.outermost(prefix))


def per_call_ms(ctx, prefix: str, own: bool, events=None,
                ) -> Optional[float]:
    """ms a serving call of the slice spends in the ``prefix`` spans:
    their self time (``own``) or all their time, over the calls."""
    sl = Slice(spans(ctx, events))
    calls = len(sl.outermost(SERVE))
    if calls == 0:
        return None
    ns = sl.self_ns(prefix) if own else sl.time_ns(prefix)
    return 1e-6 * ns / calls


def idle_in_serve_share(ctx, events=None) -> Optional[float]:
    """Percent of the slice's window in which the device ran no op while
    a serving call was open."""
    calls = Slice(spans(ctx, events)).outermost(SERVE)
    if not calls or ctx.profile.window_s <= 0:
        return None
    open_ = _union([(sp.start * 1e-9, sp.end * 1e-9) for sp in calls])
    busy = ctx.profile.busy()
    overlap, i = 0.0, 0
    for s, e in open_:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < e:
            overlap += min(e, busy[j][1]) - max(s, busy[j][0])
            j += 1
    idle = sum(e - s for s, e in open_) - overlap
    return 100.0 * idle / ctx.profile.window_s


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged
