"""Process-local metrics registry: counters, gauges, histograms.

The port's own copy of ``repro.obs.metrics`` (stdlib only, like the
reference's). Thread-safe: the serving loops, the streaming updater and
the kernel build all write into the same default registry from whatever
thread they run on.

Instruments are *families*: one name + help string, many labeled series
(``counter.inc(kernel="am_search_packed", tier="cuda")``). Label values
are stringified and the series key is canonical (sorted label names), so
``snapshot()`` output is stable across call orders; the same sequence of
operations gives the same snapshot and exposition text as the
reference's registry (``tests/test_torch_obs.py``).

Two export surfaces:

  * ``snapshot()`` — a plain-dict, JSON-serializable view (stable key
    set per instrument type); what ``--metrics-out`` writes.
  * ``render_prometheus()`` — Prometheus text exposition (v0.0.4).

Histograms use log-spaced buckets by default (``log_buckets``):
latency-shaped data spans decades.
"""
from __future__ import annotations

import math
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

LabelDict = Dict[str, str]

# Canonical series key: sorted (name, value) pairs rendered in
# Prometheus label syntax. "" is the unlabeled series.
def _series_key(labels: Dict[str, object]) -> str:
    if not labels:
        return ""
    return ",".join(f'{k}="{labels[k]}"' for k in sorted(labels))


def _parse_series_key(key: str) -> LabelDict:
    """Inverse of ``_series_key`` for well-formed keys.

    Values may themselves contain commas and ``=`` (the dispatch
    counter's ``geometry="B=4,C=5,D=32"``), so split on the quoted
    structure rather than on raw commas."""
    if not key:
        return {}
    return {m.group(1): m.group(2)
            for m in re.finditer(r'([^=,]+)="([^"]*)"', key)}


def log_buckets(lo: float = 0.01, hi: float = 10_000.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds covering [lo, hi].

    ``per_decade`` bounds per power of ten; the list always starts at
    ``lo`` and ends at (or one step past) ``hi``. A terminal +Inf
    bucket is implicit in every histogram.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    step = 10.0 ** (1.0 / per_decade)
    out: List[float] = []
    b = lo
    while b < hi * (1 + 1e-12):
        out.append(round(b, 12))
        b *= step
    return tuple(out)


class _Instrument:
    """Shared family plumbing: name, help, per-series storage, lock."""

    kind = "abstract"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[str, object] = {}

    def series(self) -> Iterator[Tuple[LabelDict, object]]:
        """Iterate (labels, value) over the family's live series."""
        with self._lock:
            items = list(self._series.items())
        for key, val in items:
            yield _parse_series_key(key), val

    def clear(self) -> None:
        with self._lock:
            self._series.clear()


class Counter(_Instrument):
    """Monotonically increasing float per labeled series."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _series_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_series_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every labeled series of the family."""
        with self._lock:
            return float(sum(self._series.values()))


class Gauge(_Instrument):
    """Last-write-wins float per labeled series."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_series_key(labels)] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = _series_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(_series_key(labels), 0.0))


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics).

    Per series: ``counts[i]`` observations <= ``buckets[i]`` (cumulative
    at export, per-bucket internally), plus an overflow slot, ``sum``
    and ``count``.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, help, lock)
        bs = tuple(float(b) for b in (buckets or log_buckets()))
        if list(bs) != sorted(set(bs)):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"strictly increasing, got {bs}")
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        key = _series_key(labels)
        with self._lock:
            st = self._series.get(key)
            if st is None:
                st = {"counts": [0] * (len(self.buckets) + 1),
                      "sum": 0.0, "count": 0}
                self._series[key] = st
            # First bucket whose upper bound holds the value; the last
            # slot is +Inf.
            idx = len(self.buckets)
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    idx = i
                    break
            st["counts"][idx] += 1
            st["sum"] += float(value)
            st["count"] += 1


class Registry:
    """Named instrument families behind one lock.

    ``counter``/``gauge``/``histogram`` are idempotent getters-or-
    creators; re-registering a name as a different kind (or a histogram
    with different buckets) raises — a name collision is a bug, not a
    merge.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._families: Dict[str, _Instrument] = {}

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, requested {cls.kind}")
                if (cls is Histogram and kw.get("buckets") is not None
                        and tuple(map(float, kw["buckets"])) != fam.buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"different buckets")
                return fam
            fam = cls(name, help, self._lock, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Clear every family's series, keeping the families themselves
        (live references held by listeners/dispatch sites stay valid)."""
        with self._lock:
            for fam in self._families.values():
                fam.clear()

    def snapshot(self) -> Dict[str, Dict]:
        """Stable, JSON-serializable view of every family.

        Per family: ``{"type", "help", "values": {series_key: ...}}``;
        histograms add ``"buckets"`` (upper bounds) and their values are
        ``{"counts" (cumulative, +Inf last), "sum", "count"}``. Series
        keys are canonical sorted-label strings, so two snapshots of
        the same state are ``==``.
        """
        with self._lock:
            out: Dict[str, Dict] = {}
            for name in sorted(self._families):
                fam = self._families[name]
                entry: Dict[str, object] = {"type": fam.kind,
                                            "help": fam.help}
                if isinstance(fam, Histogram):
                    entry["buckets"] = list(fam.buckets)
                    entry["values"] = {
                        key: {"counts": _cumulative(st["counts"]),
                              "sum": st["sum"], "count": st["count"]}
                        for key, st in sorted(fam._series.items())}
                else:
                    entry["values"] = {key: val for key, val
                                       in sorted(fam._series.items())}
                out[name] = entry
            return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        snap = self.snapshot()
        for name, fam in snap.items():
            if fam["help"]:
                lines.append(f"# HELP {name} {fam['help']}")
            lines.append(f"# TYPE {name} {fam['type']}")
            if fam["type"] != "histogram":
                for key, val in fam["values"].items():
                    lines.append(f"{name}{{{key}}} {_fmt(val)}" if key
                                 else f"{name} {_fmt(val)}")
                continue
            bounds = fam["buckets"]
            for key, st in fam["values"].items():
                base = key + "," if key else ""
                for ub, cum in zip(bounds + [math.inf], st["counts"]):
                    le = "+Inf" if math.isinf(ub) else _fmt(ub)
                    lines.append(
                        f'{name}_bucket{{{base}le="{le}"}} {cum}')
                suffix = f"{{{key}}}" if key else ""
                lines.append(f"{name}_sum{suffix} {_fmt(st['sum'])}")
                lines.append(f"{name}_count{suffix} {st['count']}")
        return "\n".join(lines) + "\n"


@contextmanager
def timed_ms(hist: Histogram, **labels):
    """Observe the body's wall time (milliseconds) into ``hist``.

        with timed_ms(obs.histogram("update_fold_ms"), backend="packed"):
            fold()

    Yields a zero-arg callable returning the elapsed ms so far — after
    the block it is the recorded value (callers that also report the
    duration don't need a second clock).
    """
    t0 = time.perf_counter()
    elapsed = lambda: (time.perf_counter() - t0) * 1e3  # noqa: E731
    try:
        yield elapsed
    finally:
        hist.observe(elapsed(), **labels)


def _cumulative(counts: Sequence[int]) -> List[int]:
    out, run = [], 0
    for c in counts:
        run += c
        out.append(run)
    return out


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# The process-default registry: everything in-repo records here unless
# handed an explicit registry (tests isolate with their own instances).
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
render_prometheus = REGISTRY.render_prometheus
reset = REGISTRY.reset
