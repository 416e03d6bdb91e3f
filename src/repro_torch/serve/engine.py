"""``OnlineEngine``: the long-running MEMHD serving loop.

Port of ``repro.serve.engine``. Where ``launch/serve_memhd.py`` is a
closed-loop benchmark CLI (all
requests exist up front, ``make_batches`` greedily packs them once),
this engine serves an *open-loop timed stream*: requests arrive on a
clock, wait in an admission queue, and are closed into batches by a
**deadline-aware policy** (``plan_batch``) instead of a one-shot greedy
pass:

* requests are admitted head-first (FIFO, never split) up to
  ``max_batch`` rows;
* a batch closes immediately when full, when the tightest admitted
  deadline's slack — against an EWMA service-time model per padded
  batch bucket plus the in-flight pipeline's drain estimate — has
  shrunk to the safety margin, or when the head request has waited
  ``max_wait_ms`` (bounded staleness for best-effort traffic);
* otherwise the engine *waits for more arrivals*, trading a little
  latency headroom for larger (cheaper per row) batches.

Batches pad to a **geometric bucket grid** (tile, 2·tile, 4·tile, …,
max_batch) so the warmup runs every batch shape the stream will ever
hit: launch plans, fold scratch and allocator segments exist before the
steady window. The ``depth``-deep pipeline is kept: up to ``depth``
batches stay in flight while the host plans the next one. A batch is
launched, a ``torch.cuda.Event`` recorded behind it, and the host
synchronizes on that event only when it drains the batch (nothing at
dispatch reads the device back); on the CPU a dispatch completes at
once.

Live updates ride a ``StreamingUpdater``: labeled ``Feedback`` events
buffer into it, folds produce a new immutable artifact generation, and
the engine swaps it in as a reference replacement. Batches already
launched read the old generation's tensors, which the swap leaves
intact, so they finish against the old artifact bit for bit. Same-shape
swaps (equal ``swap_signature``) reuse the warmed plans; a class-growth
swap re-warms the bucket grid once, inside an excluded window.

The ``dispatch``, ``device_wait``, ``fold`` and ``rewarm`` spans are
also ``torch.profiler.record_function`` ranges, so a profiler trace of a
stream splits its time between serving, folds and re-warms.

Rebuild accounting is per-phase. JAX counts XLA compiles; the port
counts what it builds at run time: nvcc builds of the kernel library
and CUDA graph captures (``obs.torchmon.rebuilds``). The ``warmup`` /
``fold`` / ``rewarm`` windows are excluded, and everything else observed
between ``serve()`` entry and exit is reported as
``recompiles_steady_state`` (the reference's name) — the number that
must stay 0.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.deploy.padding import round_up
from repro_torch.obs import span
from repro_torch.serve.stream import Arrival, OnlineRequest

log = logging.getLogger("serve.engine")

TILE_B = 8  # batch padding granularity (float32 sublane tile)


def batch_buckets(tile: int, max_batch: int) -> List[int]:
    """The geometric padded-rows grid: tile, 2·tile, …, >= max_batch.

    Geometric (not linear) so the warmup set stays logarithmic in
    ``max_batch`` while the worst-case pad overhead is bounded at 2x —
    the standard bucketed-serving trade.
    """
    if tile < 1 or max_batch < 1:
        raise ValueError("tile and max_batch must be >= 1")
    top = round_up(max_batch, tile)
    out = []
    b = tile
    while b < top:
        out.append(b)
        b *= 2
    out.append(top)
    return out


class ServiceModel:
    """EWMA service-time estimate per padded-rows bucket.

    Seeded by the warmup's second, timed call per bucket; every drained
    batch refines it. The estimate feeds ``plan_batch``'s slack
    computation — it need only be the right order of magnitude for the
    policy to close batches before deadlines burn.
    """

    def __init__(self, default_s: float = 0.005, alpha: float = 0.25):
        self.default_s = default_s
        self.alpha = alpha
        self._est: Dict[int, float] = {}

    def observe(self, bucket: int, seconds: float) -> None:
        prev = self._est.get(bucket)
        self._est[bucket] = (seconds if prev is None else
                             (1 - self.alpha) * prev + self.alpha * seconds)

    def estimate(self, bucket: int) -> float:
        est = self._est.get(bucket)
        if est is not None:
            return est
        known = sorted(self._est)
        if known:  # nearest known bucket beats the blind default
            near = min(known, key=lambda b: abs(b - bucket))
            return self._est[near] * max(1.0, bucket / near)
        return self.default_s


def plan_batch(queue: Sequence[OnlineRequest], now: float, *,
               max_batch: int, estimate_rows_s: Callable[[int], float],
               inflight_eta_s: float = 0.0, margin_s: float = 0.002,
               max_wait_s: float = 0.05, flush: bool = False) -> int:
    """Deadline-aware admission: close a batch now, or keep waiting?

    Returns how many head-of-queue requests to close into a batch at
    ``now`` (0 = wait for more arrivals). Requests admit FIFO and never
    split; a batch closes when it is full, when the tightest admitted
    deadline could no longer absorb further waiting (its slack against
    estimated completion — in-flight drain + this batch's service —
    has shrunk to ``margin_s``), or when the head request's wait hits
    ``max_wait_s``. ``flush=True`` (no more arrivals can come) closes
    any non-empty batch immediately — waiting buys nothing.
    """
    admit = 0
    rows = 0
    for r in queue:
        if admit and rows + r.size > max_batch:
            break
        admit += 1
        rows += r.size
    if admit == 0:
        return 0
    if rows >= max_batch or flush:
        return admit
    deadlines = [r.t_deadline for r in list(queue)[:admit]
                 if r.t_deadline is not None]
    if deadlines:
        eta = now + inflight_eta_s + estimate_rows_s(rows)
        if min(deadlines) - eta <= margin_s:
            return admit
    if now - queue[0].t_arrival >= max_wait_s:
        return admit
    return 0


@dataclasses.dataclass
class _Inflight:
    requests: List[OnlineRequest]
    n_valid: int
    future: torch.Tensor
    event: Optional[torch.cuda.Event]  # None on the CPU: already done
    t_dispatch: float
    generation: int
    bucket: int


class OnlineEngine:
    """Async request-queue serving engine with live model updates.

    Args:
      updater: the ``StreamingUpdater`` owning the live model and the
        served artifact (the engine always serves ``updater.artifact``
        — folding swaps generations under the engine atomically).
      max_batch: batch budget in rows; requests larger than this are
        rejected at ingest (requests never split).
      tile: padding granularity; lifted to the artifact's
        ``row_multiple`` where it has one.
      depth: double-buffer depth — batches in flight while the host
        plans the next one.
      fused: serve through ``predict_features`` (fused pipeline).
      margin_ms / max_wait_ms: the batching policy's safety margin and
        best-effort staleness bound.
      warmup: run (and re-run after class growth) every bucket shape
        before serving — the zero-steady-state-rebuild contract.
      events: optional ``obs.EventLog`` shared with the updater.
    """

    def __init__(self, updater, *, max_batch: int = 256,
                 tile: int = TILE_B, depth: int = 2, fused: bool = False,
                 margin_ms: float = 2.0, max_wait_ms: float = 50.0,
                 warmup: bool = True,
                 events: Optional[obs.EventLog] = None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        obs.install()  # rebuild accounting reads the torchmon counters
        self.updater = updater
        self.tile = math.lcm(tile, getattr(updater.artifact,
                                           "row_multiple", 1))
        self.max_batch = max(round_up(max_batch, self.tile), self.tile)
        self.buckets = batch_buckets(self.tile, self.max_batch)
        self.depth = depth
        self.fused = fused
        self.margin_s = margin_ms / 1e3
        self.max_wait_s = max_wait_ms / 1e3
        self.warmup_enabled = warmup
        self.events = events or obs.EventLog(None)
        self.service_model = ServiceModel()
        self.queue: deque = deque()
        self.responses: Dict[int, np.ndarray] = {}
        self.request_lat_ms: Dict[int, float] = {}
        # rid -> the model generation whose artifact served it.
        self.request_generation: Dict[int, int] = {}
        self._inflight: deque = deque()
        self._feature_spec = None  # (n_features, dtype) after first batch
        self._t0 = None
        self._last_ready = 0.0
        self._lat_ms: List[float] = []
        self._service_ms: List[float] = []
        self._batch_rows: List[int] = []
        self._rows_padded = 0
        self._served = 0
        self._deadline_total = 0
        self._deadline_missed = 0
        self._generations: List[Dict] = []
        self._excluded = {"warmup": 0, "fold": 0, "rewarm": 0}
        self._compiles_at_start = None
        self._hist = obs.histogram(
            "online_batch_ms", "online engine per-batch latency by stage")
        self._gauge_q = obs.gauge("online_queue_depth",
                                  "admission-queue length at dispatch")

    # -- plumbing -------------------------------------------------------------
    @property
    def artifact(self):
        """The currently-served artifact (the updater's latest swap)."""
        return self.updater.artifact

    def _predict(self, x: np.ndarray) -> torch.Tensor:
        a = self.artifact
        t = torch.from_numpy(x)
        if a.device.type == "cuda":
            t = t.pin_memory().to(a.device, non_blocking=True)
        return (a.predict_features if self.fused else a.predict)(t)

    def _ready_event(self) -> Optional[torch.cuda.Event]:
        """An event behind the work just launched (None on the CPU)."""
        device = self.artifact.device
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _sync(self) -> None:
        device = self.artifact.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        raise ValueError(f"{rows} rows exceed max_batch={self.max_batch}")

    def _estimate_rows_s(self, rows: int) -> float:
        return self.service_model.estimate(self._bucket_for(rows))

    def _inflight_eta_s(self) -> float:
        return sum(self.service_model.estimate(f.bucket)
                   for f in self._inflight)

    @contextmanager
    def _excluded_window(self, kind: str):
        """Rebuilds observed inside don't count as steady-state."""
        c0 = obs.torchmon.rebuilds()
        try:
            yield
        finally:
            self._excluded[kind] += obs.torchmon.rebuilds() - c0

    def steady_state_recompiles(self) -> int:
        """Kernel builds + graph captures since ``serve()`` entry outside
        the excluded warmup / fold / rewarm windows — the number that
        must stay 0."""
        if self._compiles_at_start is None:
            return 0
        return (obs.torchmon.rebuilds() - self._compiles_at_start
                - sum(self._excluded.values()))

    # -- warmup ---------------------------------------------------------------
    def _warm_buckets(self, window: str) -> None:
        n_feats, dtype = self._feature_spec
        with self._excluded_window(window):
            for b in self.buckets:
                x = np.zeros((b, n_feats), dtype)
                self._predict(x)
                self._sync()
                t0 = time.perf_counter()
                self._predict(x)
                self._sync()
                self.service_model.observe(b, time.perf_counter() - t0)

    # -- dispatch / drain -----------------------------------------------------
    def _dispatch(self, requests: List[OnlineRequest]) -> None:
        with span("host_prep", requests=len(requests)):
            feats = (requests[0].feats if len(requests) == 1 else
                     np.concatenate([r.feats for r in requests]))
            rows = feats.shape[0]
            bucket = self._bucket_for(rows)
            with span("pad", rows=rows, bucket=bucket):
                padded = np.zeros((bucket,) + feats.shape[1:],
                                  feats.dtype)
                padded[:rows] = feats
        self._rows_padded += bucket
        self._batch_rows.append(rows)
        self._gauge_q.set(len(self.queue))
        t_disp = self._clock()
        with span("dispatch", device=True, rows=bucket):
            fut = self._predict(padded)
            event = self._ready_event()
        self._inflight.append(_Inflight(
            requests=requests, n_valid=rows, future=fut, event=event,
            t_dispatch=t_disp, generation=self.updater.generation,
            bucket=bucket))

    def _drain_one(self) -> None:
        f: _Inflight = self._inflight.popleft()
        with span("device_wait", device=True, rows=f.bucket):
            if f.event is not None:
                f.event.synchronize()
        t_ready = self._clock()
        service = t_ready - max(f.t_dispatch, self._last_ready)
        self._last_ready = t_ready
        self.service_model.observe(f.bucket, service)
        self._service_ms.append(service * 1e3)
        self._hist.observe((t_ready - f.t_dispatch) * 1e3, stage="batch")
        self._hist.observe(service * 1e3, stage="service")
        pred = f.future.cpu().numpy()[:f.n_valid]
        ofs = 0
        for r in f.requests:
            self.responses[r.rid] = pred[ofs:ofs + r.size]
            ofs += r.size
            self._served += 1
            lat_ms = (t_ready - r.t_arrival) * 1e3
            self._lat_ms.append(lat_ms)
            self.request_lat_ms[r.rid] = lat_ms
            self.request_generation[r.rid] = f.generation
            self._hist.observe(lat_ms, stage="request")
            if r.deadline_ms is not None:
                self._deadline_total += 1
                if lat_ms > r.deadline_ms:
                    self._deadline_missed += 1

    # -- live updates ---------------------------------------------------------
    def _quiesce(self) -> None:
        """Dispatch and drain everything already admitted.

        Runs right before a fold: queries that entered the queue before
        the feedback complete on the generation they were admitted
        under, and the fold never holds a half-built batch hostage.
        """
        now = self._clock() if self._t0 is not None else 0.0
        while self.queue:
            if len(self._inflight) >= self.depth:
                self._drain_one()
                continue
            n = plan_batch(self.queue, now, max_batch=self.max_batch,
                           estimate_rows_s=self._estimate_rows_s,
                           flush=True)
            self._dispatch([self.queue.popleft() for _ in range(n)])
        while self._inflight:
            self._drain_one()

    def _fold_and_swap(self) -> None:
        self._quiesce()
        steady_before = self.steady_state_recompiles()
        with span("fold", device=True,
                  generation=self.updater.generation + 1):
            with self._excluded_window("fold"):
                result = self.updater.fold()
        if result is None:
            return
        if (not result.shape_stable and self.warmup_enabled
                and self._feature_spec is not None):
            with span("rewarm", device=True, generation=result.generation):
                self._warm_buckets("rewarm")
        cfg = self.updater.model.am_cfg
        rec = {
            "generation": result.generation,
            "t": round(self._clock(), 3) if self._t0 is not None else 0.0,
            "shape_stable": result.shape_stable,
            "fold_ms": round(result.fold_ms, 3),
            "n_samples": result.n_samples,
            "n_new_classes": result.n_new_classes,
            "classes": cfg.classes,
            "columns": cfg.columns,
            "steady_recompiles_before_swap": steady_before,
        }
        self._generations.append(rec)
        self.events.emit("generation_swap", **rec)

    # -- the loop -------------------------------------------------------------
    def serve(self, events: Sequence) -> Dict:
        """Replay a timed event stream to completion; returns the report.

        ``events`` is any mix of ``Arrival`` / ``Feedback`` (sorted here
        by ``stream.merge_events`` ordering). The engine runs on a real
        clock starting at the first event's ingestion: it sleeps through
        idle gaps, so a 200-request stream at 50 QPS genuinely takes
        ~4 s of wall time — latency percentiles and deadline misses are
        measured, not simulated.
        """
        from repro_torch.serve.stream import merge_events
        # One serve() = one report: measurement accumulators reset here
        # (``responses`` / ``request_lat_ms`` keep accumulating so
        # callers can run phased scenarios as separate serves and still
        # score every rid afterwards).
        self._lat_ms, self._service_ms, self._batch_rows = [], [], []
        self._rows_padded = 0
        self._served = 0
        self._deadline_total = self._deadline_missed = 0
        self._generations = []
        self._excluded = {"warmup": 0, "fold": 0, "rewarm": 0}
        events = merge_events(list(events))
        first = next((e for e in events if isinstance(e, Arrival)), None)
        if first is not None:
            big = max(e.request.size for e in events
                      if isinstance(e, Arrival))
            if big > self.max_batch:
                raise ValueError(
                    f"request of {big} rows exceeds max_batch="
                    f"{self.max_batch} (requests never split)")
            self._feature_spec = (first.request.feats.shape[1],
                                  first.request.feats.dtype)
        self._compiles_at_start = obs.torchmon.rebuilds()
        if self.warmup_enabled and self._feature_spec is not None:
            self._warm_buckets("warmup")
        self._t0 = time.perf_counter()
        self._last_ready = 0.0
        self.events.emit("serve_start", events=len(events),
                         buckets=self.buckets, depth=self.depth)
        i = 0
        while i < len(events) or self.queue or self._inflight:
            now = self._clock()
            while i < len(events) and events[i].t <= now:
                ev = events[i]
                i += 1
                if isinstance(ev, Arrival):
                    self.queue.append(ev.request)
                else:
                    self.updater.ingest(ev.feats, ev.labels)
                    if ev.fold or self.updater.should_fold:
                        self._fold_and_swap()
            flush = i >= len(events)
            n = plan_batch(
                self.queue, now, max_batch=self.max_batch,
                estimate_rows_s=self._estimate_rows_s,
                inflight_eta_s=self._inflight_eta_s(),
                margin_s=self.margin_s, max_wait_s=self.max_wait_s,
                flush=flush)
            if n:
                if len(self._inflight) >= self.depth:
                    self._drain_one()  # pipeline full: free a slot
                    continue
                self._dispatch([self.queue.popleft() for _ in range(n)])
                continue
            # Idle: nothing to close yet. Drain in-flight work if any
            # (blocking on the device doubles as the sleep), else sleep
            # until the next arrival or the forced-dispatch instant.
            if self._inflight:
                self._drain_one()
                continue
            wake = events[i].t if i < len(events) else None
            if self.queue:
                head = self.queue[0]
                t_force = head.t_arrival + self.max_wait_s
                deadlines = [r.t_deadline for r in self.queue
                             if r.t_deadline is not None]
                if deadlines:
                    rows = sum(r.size for r in self.queue)
                    rows = min(rows, self.max_batch)
                    t_force = min(t_force,
                                  min(deadlines) - self._estimate_rows_s(rows)
                                  - self.margin_s)
                wake = t_force if wake is None else min(wake, t_force)
            if wake is None:
                break
            dt = wake - self._clock()
            if dt > 0:
                time.sleep(min(dt, 0.05))
        while self._inflight:
            self._drain_one()
        wall = self._clock()
        obs.counter("serve_rows_total",
                    "feature rows served (pre-padding)"
                    ).inc(sum(self._batch_rows))
        obs.counter("serve_requests_total",
                    "classification requests served").inc(self._served)
        self.events.emit("serve_end", wall_s=round(wall, 3),
                         requests=self._served)
        return self.report(wall)

    # -- reporting ------------------------------------------------------------
    def report(self, wall_s: float) -> Dict:
        """The engine's JSON report (the online analogue of
        ``serve_memhd.build_report``'s stats section)."""
        rows_real = sum(self._batch_rows)
        lat = np.asarray(self._lat_ms) if self._lat_ms else None

        def pct(p):
            return (round(float(np.percentile(lat, p)), 3)
                    if lat is not None else None)

        return {
            "requests": self._served,
            "rows": rows_real,
            "batches": len(self._batch_rows),
            "avg_batch_rows": (round(rows_real / len(self._batch_rows), 2)
                               if self._batch_rows else None),
            "rows_padded": self._rows_padded,
            "pad_overhead": (round(self._rows_padded / rows_real - 1, 3)
                             if rows_real else None),
            "buckets": self.buckets,
            "depth": self.depth,
            "wall_s": round(wall_s, 3),
            "qps": (round(self._served / wall_s, 1)
                    if wall_s else 0.0),
            "rows_per_s": (round(rows_real / wall_s, 1) if wall_s
                           else 0.0),
            "lat_ms_min": (round(float(lat.min()), 3)
                           if lat is not None else None),
            "lat_ms_p50": pct(50),
            "lat_ms_p95": pct(95),
            "lat_ms_p99": pct(99),
            "service_ms_p50": (round(float(np.percentile(
                self._service_ms, 50)), 3) if self._service_ms else None),
            "deadline_total": self._deadline_total,
            "deadline_miss_rate": (
                round(self._deadline_missed / self._deadline_total, 4)
                if self._deadline_total else None),
            "model_generation": self.updater.generation,
            "generations": list(self._generations),
            "recompiles_steady_state": self.steady_state_recompiles(),
            "recompiles_excluded": dict(self._excluded),
        }
