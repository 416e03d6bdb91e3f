"""Timed event streams for the online serving engine.

Port of ``repro.serve.stream`` (numpy only, so the same seed gives the
same stream bit for bit). The engine (``repro_torch.serve.engine``)
consumes a time-ordered list of events — query ``Arrival``s and labeled
``Feedback`` — and replays them against a wall clock. This module holds
the event types plus the synthetic generators the CLI and the tests
build scenarios from:

* ``poisson_arrivals`` — an open-loop Poisson request process over a
  feature pool (the classic serving-benchmark arrival model; the
  closed-loop ``serve_memhd`` CLI has no arrival process at all).
* ``feedback_burst`` — a labeled feedback batch at a point in stream
  time, optionally forcing an immediate fold.
* ``apply_drift`` — a deterministic covariate shift of a feature pool
  (convex mix with a feature rotation), used to stage the
  fold-recovers-accuracy scenarios.

Events are plain frozen dataclasses sorted by ``t`` (seconds from
stream start); ``merge_events`` interleaves independently generated
sub-streams.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class OnlineRequest:
    """One classification request with an arrival time and a deadline.

    ``t_arrival`` is seconds from stream start (the engine's clock
    zero); ``deadline_ms`` is the per-request latency budget the
    deadline-aware batcher plans against (None = best-effort).
    """

    rid: int
    feats: np.ndarray  # (n, f)
    t_arrival: float = 0.0
    deadline_ms: Optional[float] = None
    labels: Optional[np.ndarray] = None  # ground truth, scoring only —
    # the engine never reads it (serving is label-blind); the CLI and
    # benchmarks use it to report per-phase accuracy.

    @property
    def size(self) -> int:
        return self.feats.shape[0]

    @property
    def t_deadline(self) -> Optional[float]:
        """Absolute deadline in stream seconds, or None."""
        if self.deadline_ms is None:
            return None
        return self.t_arrival + self.deadline_ms / 1e3


@dataclasses.dataclass(frozen=True)
class Arrival:
    """A query request entering the engine's admission queue at ``t``."""

    t: float
    request: OnlineRequest


@dataclasses.dataclass(frozen=True)
class Feedback:
    """Labeled ground truth arriving mid-stream at ``t``.

    The engine hands (feats, labels) to its ``StreamingUpdater``;
    ``fold=True`` forces an immediate fold + artifact swap instead of
    waiting for the updater's buffer policy.
    """

    t: float
    feats: np.ndarray   # (n, f)
    labels: np.ndarray  # (n,)
    fold: bool = False


def merge_events(*streams: Sequence) -> List:
    """Interleave event sub-streams into one time-ordered list.

    Ties break by kind — feedback before arrivals at the same instant,
    so a fold scheduled "at t" applies to queries arriving "at t" —
    then by original order (stable).
    """
    def key(ev):
        return (ev.t, 0 if isinstance(ev, Feedback) else 1)
    out: List = []
    for s in streams:
        out.extend(s)
    out.sort(key=key)
    return out


def poisson_arrivals(feats_pool: np.ndarray, *, n_requests: int,
                     rate_qps: float, max_size: int = 8,
                     deadline_ms: Optional[float] = None,
                     labels_pool: Optional[np.ndarray] = None,
                     classes: Optional[Sequence[int]] = None,
                     start: float = 0.0, rid_base: int = 0,
                     seed: int = 0) -> List[Arrival]:
    """Open-loop Poisson request stream sampled from a feature pool.

    Inter-arrival gaps are exponential with mean ``1/rate_qps``; each
    request draws 1..``max_size`` rows from ``feats_pool`` (restricted
    to rows whose ``labels_pool`` entry is in ``classes``, when given —
    how scenarios serve only currently-known classes before an append).
    """
    if rate_qps <= 0:
        raise ValueError(f"rate_qps must be > 0, got {rate_qps}")
    rng = np.random.default_rng(seed)
    pool = np.arange(feats_pool.shape[0])
    if classes is not None:
        if labels_pool is None:
            raise ValueError("classes filter needs labels_pool")
        pool = pool[np.isin(np.asarray(labels_pool), list(classes))]
    if pool.size == 0:
        raise ValueError("empty feature pool after class filter")
    out: List[Arrival] = []
    t = start
    for i in range(n_requests):
        t += float(rng.exponential(1.0 / rate_qps))
        rows = rng.choice(pool, size=int(rng.integers(1, max_size + 1)))
        req = OnlineRequest(
            rid=rid_base + i, feats=feats_pool[rows], t_arrival=t,
            deadline_ms=deadline_ms,
            labels=(None if labels_pool is None
                    else np.asarray(labels_pool)[rows]))
        out.append(Arrival(t=t, request=req))
    return out


def feedback_burst(feats: np.ndarray, labels: np.ndarray, *, t: float,
                   chunk: Optional[int] = None, fold: bool = False,
                   ) -> List[Feedback]:
    """Labeled feedback at stream time ``t``, optionally chunked.

    With ``chunk`` the burst splits into several ``Feedback`` events at
    the same instant (exercises the updater's buffering); only the last
    carries the ``fold`` flag.
    """
    n = feats.shape[0]
    if n != np.asarray(labels).shape[0]:
        raise ValueError("feats/labels length mismatch")
    step = n if chunk is None else max(int(chunk), 1)
    out: List[Feedback] = []
    for i in range(0, n, step):
        out.append(Feedback(t=t, feats=feats[i:i + step],
                            labels=np.asarray(labels[i:i + step]),
                            fold=False))
    if out and fold:
        out[-1] = dataclasses.replace(out[-1], fold=True)
    return out


def apply_drift(feats: np.ndarray, strength: float,
                shift: int = 7) -> np.ndarray:
    """Deterministic covariate drift: mix each row with a feature roll.

    ``x' = (1 - s)·x + s·roll(x, shift)`` — at s=0 the identity, at
    s=1 a pure feature permutation. A projection encoder sees this as a
    systematic query rotation, so accuracy degrades smoothly with
    ``strength`` and labeled drifted feedback recovers it — the
    fold-on-feedback scenario of tests and the quickstart.
    """
    if not 0.0 <= strength <= 1.0:
        raise ValueError(f"strength must be in [0, 1], got {strength}")
    x = np.asarray(feats)
    return ((1.0 - strength) * x
            + strength * np.roll(x, shift, axis=-1)).astype(x.dtype)
