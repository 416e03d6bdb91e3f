"""Batched MEMHD serving: the packed-AM classification workload.

Port of ``repro.launch.serve_memhd``. A stream of classification
requests (blocks of raw feature rows) is greedily packed into batches (a
request never splits), each batch is zero-padded up to a tile multiple,
and batches are served through a pipeline ``--depth`` batches deep: the
host pads batch k+1 while batch k runs on the device. ``--fused`` serves
each batch through ``predict_features`` (the ``encode_pack`` kernel
chained into the packed search); the default serves the staged encode
-> binarize -> ``pack_bits`` -> ``am_search_packed`` path. ``--mode
unpack`` serves the packed AM through the unpack mode of the packed
search, and ``--target unpacked`` (or ``--unpacked``) the ±1 float AM
through ``am_search``. Predictions are bit-exact across all of them.

The JSON report keeps the reference's keys; its ``metrics`` section
holds the port's dispatch tiers (``cuda`` / ``torch-ref``).

Usage (on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke --fused \
      --requests 64 --max-batch 256
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke \
      --target unpacked
and ``--device cpu`` for the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.deploy.padding import pad_to_multiple, round_up

log = logging.getLogger("serve_memhd")

TILE_B = 8  # batch padding granularity


@dataclasses.dataclass(frozen=True)
class Request:
    """One classification request: a block of feature rows."""

    rid: int
    feats: np.ndarray  # (n, f)

    @property
    def size(self) -> int:
        return self.feats.shape[0]


def make_batches(requests: Sequence[Request], max_batch: int,
                 ) -> List[List[Request]]:
    """Greedy first-fit batching: fill up to ``max_batch`` rows per batch.

    Requests are taken in arrival order and never split; a request larger
    than ``max_batch`` gets a batch of its own.
    """
    batches: List[List[Request]] = []
    cur: List[Request] = []
    cur_rows = 0
    for req in requests:
        if cur and cur_rows + req.size > max_batch:
            batches.append(cur)
            cur, cur_rows = [], 0
        cur.append(req)
        cur_rows += req.size
    if cur:
        batches.append(cur)
    return batches


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host batch -> device tensor; pinned + asynchronous for CUDA."""
    t = torch.from_numpy(x)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def serve_batches(deployed, requests: Sequence[Request],
                  max_batch: int = 256, tile: int = TILE_B,
                  warmup: bool = True, fused: bool = False,
                  depth: int = 1, topk: int = 0,
                  ) -> Tuple[Dict[int, np.ndarray], Dict]:
    """Run the request stream through the deployed model.

    ``warmup=True`` first runs every distinct padded batch shape the
    stream will hit once (building the CUDA kernels on first use), so
    the reported latencies measure serving. ``fused=True`` serves each
    batch through ``predict_features`` instead of the staged ``predict``.

    ``depth`` is the pipeline depth: up to ``depth`` batches may be in
    flight on the device while the host concatenates and pads the next
    one. An event recorded after each dispatch is synchronized when the
    batch is drained, so latency decomposes as in the reference:
    ``lat_ms_*`` (dispatch -> result ready) = ``queue_ms_*`` (waiting
    behind earlier batches on the one in-order stream) +
    ``service_ms_*``; at ``depth=1`` the queue wait is zero.

    Returns (responses, stats): responses maps rid -> (n,) predicted
    classes; stats holds per-batch latencies and padding accounting.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if topk:
        raise NotImplementedError(
            "top-k serving is not ported yet (ROADMAP queue 1, item 11)")
    device = deployed.device
    predict = deployed.predict_features if fused else deployed.predict
    batches = make_batches(requests, max_batch)
    if warmup and requests:
        n_feats = requests[0].feats.shape[1]
        dtype = requests[0].feats.dtype
        shapes = {round_up(sum(r.size for r in b), tile) for b in batches}
        for rows in sorted(shapes):
            predict(_to_device(np.zeros((rows, n_feats), dtype), device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    responses: Dict[int, np.ndarray] = {}
    lat_ms: List[float] = []
    queue_ms: List[float] = []
    service_ms: List[float] = []
    rows_real = rows_padded = 0
    inflight: deque = deque()  # (batch, n_valid, result, event, t_disp)
    last_ready = [float("-inf")]  # when the device finished batch k-1

    def _drain_one():
        batch, n_valid, fut, event, t_disp = inflight.popleft()
        if event is not None:
            event.synchronize()
        t_ready = time.perf_counter()
        # In-order device queue: time up to the previous batch's
        # completion is queue wait, the rest this batch's service time.
        lat = t_ready - t_disp
        queue = min(lat, max(0.0, last_ready[0] - t_disp))
        last_ready[0] = t_ready
        lat_ms.append(lat * 1e3)
        queue_ms.append(queue * 1e3)
        service_ms.append((lat - queue) * 1e3)
        pred = fut.cpu().numpy()[:n_valid]
        ofs = 0
        for r in batch:
            responses[r.rid] = pred[ofs:ofs + r.size]
            ofs += r.size

    for batch in batches:
        # Host-side prep of batch k+1 overlaps device work on batch k.
        feats = np.concatenate([r.feats for r in batch])
        padded, n_valid = pad_to_multiple(feats, tile)
        rows_real += n_valid
        rows_padded += padded.shape[0]
        t0 = time.perf_counter()
        fut = predict(_to_device(padded, device))
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        inflight.append((batch, n_valid, fut, event, t0))
        while len(inflight) >= depth:
            _drain_one()
    while inflight:
        _drain_one()
    stats = {
        "depth": depth,
        "batches": len(batches),
        "rows_real": rows_real,
        "rows_padded": rows_padded,
        "pad_overhead": (round(rows_padded / rows_real - 1, 3)
                         if rows_real else None),
        **_lat_fields("lat_ms", lat_ms),
        **_lat_fields("service_ms", service_ms),
        **_lat_fields("queue_ms", queue_ms),
    }
    return responses, stats


def _lat_fields(prefix: str, vals: List[float],
                ) -> Dict[str, Optional[float]]:
    """min/p50/p95/p99/total fields for one latency series; all None
    when the stream produced no batches."""
    if not vals:
        return {f"{prefix}_{s}": None
                for s in ("min", "p50", "p95", "p99", "total")}
    a = np.asarray(vals)
    return {
        f"{prefix}_min": round(float(a.min()), 3),
        f"{prefix}_p50": round(float(np.percentile(a, 50)), 3),
        f"{prefix}_p95": round(float(np.percentile(a, 95)), 3),
        f"{prefix}_p99": round(float(np.percentile(a, 99)), 3),
        f"{prefix}_total": round(float(a.sum()), 3),
    }


def synthetic_requests(feats: np.ndarray, n_requests: int,
                       max_size: int, seed: int = 0) -> List[Request]:
    """Ragged request stream sampled from a feature pool."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        n = int(rng.integers(1, max_size + 1))
        rows = rng.integers(0, feats.shape[0], size=n)
        reqs.append(Request(rid=rid, feats=feats[rows]))
    return reqs


def metrics_summary() -> Dict:
    """The report's ``metrics`` section: which tier (``cuda`` kernel or
    ``torch-ref`` plain version) served each kernel dispatch. The
    reference's compile counters wait for the observability slice
    (ROADMAP queue 1, item 15)."""
    from repro_torch.kernels import ops
    return {"dispatch_tiers": ops.dispatch_breakdown()}


def build_report(deployed, requests: Sequence[Request], stats: Dict,
                 wall_s: float, fused: bool = False, topk: int = 0,
                 metrics: Optional[Dict] = None) -> Dict:
    """Assemble the serving JSON report (the reference's key set)."""
    n_rows = sum(r.size for r in requests)
    devices = int(getattr(deployed, "n_devices", 1))
    rows_per_s = round(n_rows / wall_s, 1) if wall_s else 0.0
    return {
        "workload": "memhd_classify",
        "backend": deployed.backend,
        "devices": devices,
        "packed": bool(getattr(deployed, "packed", False)),
        "mode": deployed.serving_mode,
        "pipeline": "fused" if fused else "staged",
        "topk": int(topk),
        "geometry": f"{deployed.am_cfg.dim}x{deployed.am_cfg.columns}",
        "requests": len(requests),
        "rows": n_rows,
        "wall_s": round(wall_s, 3),
        "qps": round(len(requests) / wall_s, 1) if wall_s else 0.0,
        "rows_per_s": rows_per_s,
        "rows_per_s_per_device": round(rows_per_s / devices, 1),
        "resident_am_bytes": deployed.resident_am_bytes,
        "am_memory_ratio": round(deployed.am_memory_ratio, 2),
        "metrics": metrics if metrics is not None else metrics_summary(),
        **stats,
    }


def _not_ported(flag: str, item: str):
    raise NotImplementedError(f"{flag} is not ported yet ({item})")


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny training budget (CI-sized)")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--max-size", type=int, default=32,
                    help="max rows per request")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--target", default=None,
                    choices=["packed", "unpacked", "imc", "hierarchical",
                             "multibit"],
                    help="deployment backend (packed and unpacked are "
                         "ported)")
    ap.add_argument("--cell-bits", type=int, default=4,
                    help="multibit: bits per resident AM cell (2-8)")
    ap.add_argument("--mode", default="popcount",
                    choices=["popcount", "unpack"])
    ap.add_argument("--topk", type=int, default=0,
                    help="top-k serving (not ported); 0 = argmax serving")
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--shortlist", type=int, default=None)
    ap.add_argument("--unpacked", action="store_true",
                    help="legacy alias for --target unpacked")
    ap.add_argument("--fused", action="store_true",
                    help="serve raw features through the fused "
                         "encode->pack->search pipeline")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel serving devices (only 1 ported)")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipeline depth (batches in flight)")
    ap.add_argument("--record-dir", default=None)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--log-json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    if args.target and args.unpacked:
        ap.error("--unpacked is the legacy alias; drop it with --target")
    target = args.target or ("unpacked" if args.unpacked else "packed")
    if target not in ("packed", "unpacked"):
        _not_ported(f"--target {target}", "ROADMAP queue 1, items 9-11")
    if args.fused and target != "packed":
        ap.error("--fused needs the packed backend (--target packed)")
    if args.topk or args.groups or args.shortlist:
        _not_ported("--topk/--groups/--shortlist",
                    "ROADMAP queue 1, item 11")
    if args.devices > 1:
        _not_ported("--devices > 1", "ROADMAP queue 1, item 13")
    if args.record_dir:
        _not_ported("--record-dir", "ROADMAP queue 1, item 16")
    if args.metrics_out or args.trace_out or args.log_json:
        _not_ported("--metrics-out/--trace-out/--log-json",
                    "ROADMAP queue 1, item 15")

    from repro_torch import resolve_device
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset

    device = resolve_device(args.device)
    per_class = 80 if args.smoke else 400
    epochs = 2 if args.smoke else 20
    ds = load_dataset("mnist", train_per_class=per_class,
                      test_per_class=40, device=device)
    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=ds.classes,
                      epochs=epochs, kmeans_iters=5)
    model = MemhdModel.create(0, enc, amc, device=device)
    model, _ = model.fit(1, ds.train_x, ds.train_y)
    deployed = model.deploy(target=target, mode=args.mode)

    reqs = synthetic_requests(ds.test_x.cpu().numpy(), args.requests,
                              args.max_size)
    # The warmup pass builds the kernels and runs every padded shape; the
    # timed pass then measures serving alone.
    serve_batches(deployed, reqs, args.max_batch, fused=args.fused,
                  depth=args.depth)
    t0 = time.time()
    responses, stats = serve_batches(
        deployed, reqs, args.max_batch, warmup=False, fused=args.fused,
        depth=args.depth)
    wall = time.time() - t0
    report = build_report(deployed, reqs, stats, wall, fused=args.fused)
    print(json.dumps(report, indent=1))
    if len(responses) != len(reqs):
        raise RuntimeError(f"{len(responses)} responses for "
                           f"{len(reqs)} requests")
    return report


if __name__ == "__main__":
    main()
