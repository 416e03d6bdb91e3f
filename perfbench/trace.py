"""The traced window: device activity from ``torch.profiler``, host spans.

A ``--trace 1`` run profiles a slice of its window (CPU and CUDA
activity). From the profile this module takes the device operations
(kernels, copies, fills) that ran inside the benchmark's
``perfbench.traced`` span, the benchmark's own host spans
(``perfbench.<name>``), the device's busy time (the union of its
operations), the idle gaps between them named by the host span that was
open at each gap's middle, and the device time by operation. Per-layer
metric readers (``metrics/``) get a ``Context`` built from it.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import sys
from pathlib import Path
from typing import Optional

import torch

SPAN = "perfbench."   # the benchmark's host spans: SPAN + a name
WINDOW = "traced"     # the span around the traced slice


def _ns(ev, what: str) -> float:
    """An event's start or duration in ns (older torch reports us)."""
    fn = getattr(ev, f"{what}_ns", None)
    return float(fn()) if fn is not None else 1e3 * float(
        getattr(ev, f"{what}_us")())


@dataclasses.dataclass
class Profile:
    """One traced slice: device ops and host spans, in seconds."""

    window: tuple                  # (start, end) of the traced span
    ops: list                      # (start, end, name), device, in window
    spans: list                    # (start, end, name), host

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        """Merged (start, end) intervals in which the device ran an op."""
        merged = []
        for s, e, _ in sorted(self.ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_time(self, names) -> float:
        """Seconds of the device ops whose name holds one of ``names``."""
        return sum(e - s for s, e, n in self.ops
                   if any(k in n for k in names))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...] of the ops that took most device time."""
        by = {}
        for s, e, n in self.ops:
            by[short_name(n)] = by.get(short_name(n), 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host span, seconds], ...]: the device's idle time, summed by
        the innermost benchmark span open at each gap's middle."""
        gaps, t = [], self.window[0]
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        spans = sorted(self.spans)
        starts = [s for s, _, _ in spans]
        by = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            open_ = [sp for sp in spans[:bisect.bisect_right(starts, mid)]
                     if sp[1] >= mid]
            name = (min(open_, key=lambda sp: sp[1] - sp[0])[2]
                    if open_ else "loop")
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A device op's name without its return type, anonymous namespaces
    and argument list, at most 96 chars."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:96]


def warm_up() -> None:
    """Start and stop the profiler once: its first start sets the device's
    tracing up, which takes seconds that must not fall in a window."""
    start().stop()


def start() -> torch.profiler.profile:
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof: torch.profiler.profile) -> Profile:
    """Stop the profiler and read the slice inside ``perfbench.traced``."""
    prof.stop()
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        s = _ns(ev, "start") * 1e-9
        e = s + _ns(ev, "duration") * 1e-9
        name = ev.name()
        if name.startswith(SPAN):
            # The device timeline repeats each range as an annotation,
            # which is no operation.
            if ev.device_type() != cuda:
                host.append((s, e, name[len(SPAN):]))
        elif ev.device_type() == cuda:
            dev.append((s, e, name))
    window = next(((s, e) for s, e, n in host if n == WINDOW), None)
    if window is None:
        raise RuntimeError(f"the trace has no {SPAN + WINDOW} span")
    ops = [(max(s, window[0]), min(e, window[1]), n) for s, e, n in dev
           if e > window[0] and s < window[1]]
    spans = [sp for sp in host if sp[2] != WINDOW]
    return Profile(window, ops, spans)


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader reads: the cell's files, the traced
    slice, the calls and rows it served and what the reference says those
    rows needed, and the host's dispatch time outside the slice."""

    root: Path
    config: dict
    route: dict
    batch_rows: int
    peaks: dict
    profile: Profile
    calls: int                # artifact calls (batches) in the slice
    rows: int                 # rows those calls served
    works: list               # reference work of each call's rows
    dispatch_s: float         # host time in the artifact call ...
    dispatch_calls: int       # ... over this many untraced calls
    # The loop's own readings over the whole window (``batch_p95_ms``).
    readings: dict = dataclasses.field(default_factory=dict)

    def module(self, package: str, name: str):
        return load_module(self.root, package, name)


def load_module(root: Path, package: str, name: str):
    """``<root>/<package>/<name>.py`` as a module (None if absent)."""
    path = Path(root) / package / f"{name}.py"
    if not path.is_file():
        return None
    key = f"perfbench_{package}_{name}_{abs(hash(str(path)))}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def roofline(ctx: Context, counts) -> Optional[float]:
    """Percent of a kernel's roofline: the least time its calls in the
    slice need (``counts.bound_s``) over the device time of its ops."""
    spent = ctx.profile.device_time(counts.NAMES)
    need = counts.bound_s(ctx)
    if not spent or need is None:
        return None
    return 100.0 * need / spent


def bound(ops: float, nbytes: float, rate: float, peaks: dict) -> float:
    """Seconds: the larger of ``ops`` at ``rate`` and ``nbytes`` at the
    memory bandwidth."""
    return max(ops / rate, nbytes / peaks["hbm_byte_per_s"])
