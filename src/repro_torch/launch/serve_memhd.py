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
``--target imc`` serves the AM burned onto an ideal simulated analog
device through ``am_search_imc`` (equal to the digital predictions), and
``--target multibit --cell-bits b`` the b-bit quantized float AM through
``am_search_multibit``. ``--target hierarchical`` serves the
coarse-to-fine artifact (``am_shortlist`` over ``--groups`` super-centroids,
then ``am_search_sparse`` over ``--shortlist`` clusters' tiles), and
``--topk k`` serves each row's k best classes through its ``predict_topk``.
``--devices N`` serves through ``deploy.ShardedArtifact``: each batch cut
into N row shards over the first N GPUs (N CPU shards with ``--device
cpu``), equal to the single-device predictions.

The JSON report keeps the reference's keys; its ``metrics`` section
holds the port's dispatch tiers (``cuda`` / ``torch-ref``), the kernel
builds and graph captures (``compiles_total``, ``obs.torchmon``) and
those of the timed pass (``recompiles_steady_state``, 0 in steady
state). ``--metrics-out`` writes the metrics registry's snapshot,
``--trace-out`` the host spans as a Chrome trace, ``--record-dir`` the
report as a ``BENCH_serve_memhd.json`` record (``obs.record``: numeric
fields as metrics, the rest in ``meta``, with the device's name and
power limit).

Usage (on the GPU):
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke --fused \
      --requests 64 --max-batch 256
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke \
      --target unpacked
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke \
      --target multibit --cell-bits 4
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke \
      --target hierarchical --topk 5
  PYTHONPATH=src python -m repro_torch.launch.serve_memhd --smoke \
      --devices 2
and ``--device cpu`` for the plain path on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.deploy.padding import pad_to_multiple, round_up
from repro_torch.obs import span

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

    Each batch also emits host spans (``host_prep`` / ``pad`` /
    ``dispatch`` / ``device_wait``) and feeds the ``serve_batch_ms``
    histogram and the ``serve_rows_total`` / ``serve_requests_total``
    counters of the default metrics registry.

    ``topk >= 1`` serves through the backend's ``predict_topk`` (the
    hierarchical backend's top-k epilogue): each response row widens to
    the k best classes. It excludes ``fused``, and a backend without
    ``predict_topk`` raises ``AttributeError``.

    Returns (responses, stats): responses maps rid -> (n,) predicted
    classes ((n, topk) when ``topk >= 1``); stats holds per-batch
    latencies and padding accounting.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if topk and fused:
        raise ValueError("topk serving and the fused feature pipeline "
                         "are mutually exclusive")
    # Sharded artifacts need every batch to split evenly across shards.
    tile = math.lcm(tile, getattr(deployed, "row_multiple", 1))
    device = deployed.device
    if topk:
        if not hasattr(deployed, "predict_topk"):
            raise AttributeError(f"the {deployed.backend} backend has no "
                                 "predict_topk: top-k serving needs "
                                 "--target hierarchical")
        predict = lambda x: deployed.predict_topk(x, topk)[0]  # noqa: E731
    else:
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
    inflight: deque = deque()  # (idx, batch, n_valid, result, event, t0)
    last_ready = [float("-inf")]  # when the device finished batch k-1
    hist = obs.histogram(
        "serve_batch_ms", "per-batch serving latency by stage")
    served_rows = obs.counter("serve_rows_total",
                              "feature rows served (pre-padding)")
    served_reqs = obs.counter("serve_requests_total",
                              "classification requests served")

    def _drain_one():
        idx, batch, n_valid, fut, event, t_disp = inflight.popleft()
        with span("device_wait", batch=idx):
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
        hist.observe(lat * 1e3, stage="total")
        hist.observe(queue * 1e3, stage="queue")
        hist.observe((lat - queue) * 1e3, stage="service")
        pred = fut.cpu().numpy()[:n_valid]
        ofs = 0
        for r in batch:
            responses[r.rid] = pred[ofs:ofs + r.size]
            ofs += r.size

    for i, batch in enumerate(batches):
        # Host-side prep of batch k+1 overlaps device work on batch k.
        with span("host_prep", batch=i, requests=len(batch)):
            feats = np.concatenate([r.feats for r in batch])
            with span("pad", batch=i):
                padded, n_valid = pad_to_multiple(feats, tile)
        rows_real += n_valid
        rows_padded += padded.shape[0]
        t0 = time.perf_counter()
        with span("dispatch", batch=i, rows=padded.shape[0]):
            fut = predict(_to_device(padded, device))
            event = None
            if device.type == "cuda":
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(device))
        inflight.append((i, batch, n_valid, fut, event, t0))
        while len(inflight) >= depth:
            _drain_one()
    while inflight:
        _drain_one()
    served_rows.inc(rows_real)
    served_reqs.inc(len(requests))
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


def metrics_summary(recompiles_steady_state: Optional[int] = None,
                    ) -> Dict:
    """The report's ``metrics`` section, under the reference's keys:
    ``compiles_total``, in the port the kernel-library builds plus CUDA
    graph captures so far (``obs.torchmon.rebuilds``); those of the
    steady-state (post-warmup) window, ``recompiles_steady_state``, when
    given; and ``dispatch_tiers``, which tier (``cuda`` kernel or
    ``torch-ref`` plain version) served each kernel dispatch."""
    from repro_torch.kernels import ops
    out = {
        "compiles_total": obs.torchmon.rebuilds(),
        "dispatch_tiers": ops.dispatch_breakdown(),
    }
    if recompiles_steady_state is not None:
        out["recompiles_steady_state"] = int(recompiles_steady_state)
    return out


def build_report(deployed, requests: Sequence[Request], stats: Dict,
                 wall_s: float, fused: bool = False, topk: int = 0,
                 metrics: Optional[Dict] = None) -> Dict:
    """Assemble the serving JSON report (the reference's key set, plus
    ``cycles`` for the imc and multibit backends)."""
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
        # The device-fidelity backends also report their array passes
        # per query (the reference's report has no such key).
        **({"cycles": deployed.cycles} if hasattr(deployed, "cycles")
           else {}),
        **stats,
    }


def shard(deployed, n: int, device):
    """``deployed`` wrapped in a ``ShardedArtifact`` of ``n`` shards: the
    first ``n`` GPUs (raising if there are fewer), or ``n`` CPU shards
    when ``device`` is the CPU."""
    from repro_torch.deploy import ShardedArtifact, serving_mesh
    devices = ["cpu"] * max(n, 0) if torch.device(device).type == "cpu" \
        else None
    return ShardedArtifact(deployed, mesh=serving_mesh(devices, n=n))


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
                    help="deployment backend")
    ap.add_argument("--cell-bits", type=int, default=4,
                    help="multibit: bits per resident AM cell (2-8)")
    ap.add_argument("--mode", default="popcount",
                    choices=["popcount", "unpack"])
    ap.add_argument("--topk", type=int, default=0,
                    help="serve k candidates per row through the top-k "
                         "epilogue (hierarchical backend); 0 = argmax "
                         "serving")
    ap.add_argument("--groups", type=int, default=None,
                    help="hierarchical: G super-centroids "
                         "(default ~1.4*sqrt(C))")
    ap.add_argument("--shortlist", type=int, default=None,
                    help="hierarchical: S clusters searched per query "
                         "(default G: exact)")
    ap.add_argument("--unpacked", action="store_true",
                    help="legacy alias for --target unpacked")
    ap.add_argument("--fused", action="store_true",
                    help="serve raw features through the fused "
                         "encode->pack->search pipeline")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve through ShardedArtifact over N shards: "
                         "the first N GPUs, or N CPU shards with "
                         "--device cpu (default: no wrapper)")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipeline depth (batches in flight)")
    ap.add_argument("--record-dir", default=None,
                    help="also persist the report as a schema-versioned "
                         "BENCH_serve_memhd.json (obs.record) in this "
                         "directory")
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--log-json", action="store_true",
                    help="structured one-JSON-per-line logging")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    obs.setup_logging(json_mode=args.log_json)
    obs.install()

    if args.target and args.unpacked:
        ap.error("--unpacked is the legacy alias; drop it with --target")
    target = args.target or ("unpacked" if args.unpacked else "packed")
    if args.fused and target != "packed":
        ap.error("--fused needs the packed backend (--target packed)")
    if args.topk and target != "hierarchical":
        ap.error("--topk needs the top-k backend "
                 "(--target hierarchical)")
    if (args.groups or args.shortlist) and target != "hierarchical":
        ap.error("--groups/--shortlist only apply to "
                 "--target hierarchical")
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
    if target in ("packed", "unpacked"):
        deployed = model.deploy(target=target, mode=args.mode)
    elif target == "hierarchical":
        deployed = model.deploy(target=target, groups=args.groups,
                                shortlist=args.shortlist)
    elif target == "multibit":
        deployed = model.deploy(target=target, cell_bits=args.cell_bits)
    else:
        deployed = model.deploy(target=target)
    if args.devices is not None:
        deployed = shard(deployed, args.devices, device)
        log.info("sharded serving over %s", deployed.mesh)

    reqs = synthetic_requests(ds.test_x.cpu().numpy(), args.requests,
                              args.max_size)
    # The warmup pass builds the kernels and runs every padded shape; the
    # timed pass then measures serving alone, and must build nothing.
    with span("warmup"):
        serve_batches(deployed, reqs, args.max_batch, fused=args.fused,
                      depth=args.depth, topk=args.topk)
    with obs.count_rebuilds() as steady:
        t0 = time.time()
        with span("serve", requests=len(reqs), depth=args.depth):
            responses, stats = serve_batches(
                deployed, reqs, args.max_batch, warmup=False,
                fused=args.fused, depth=args.depth, topk=args.topk)
        wall = time.time() - t0
    obs.update_memory_gauges()
    report = build_report(
        deployed, reqs, stats, wall, fused=args.fused, topk=args.topk,
        metrics=metrics_summary(recompiles_steady_state=steady()))
    print(json.dumps(report, indent=1))
    if len(responses) != len(reqs):
        raise RuntimeError(f"{len(responses)} responses for "
                           f"{len(reqs)} requests")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(obs.snapshot(), f, indent=1)
        log.info("metrics snapshot -> %s", args.metrics_out)
    if args.trace_out:
        obs.export_chrome_trace(args.trace_out)
        log.info("chrome trace -> %s", args.trace_out)
    if args.record_dir:
        from repro_torch.obs import record
        path = record.from_report("serve_memhd", report,
                                  out_dir=args.record_dir, device=device)
        log.info("recorded -> %s", path)
    return report


if __name__ == "__main__":
    main()
