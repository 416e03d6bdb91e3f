"""Online serving CLI: a timed request stream with live updates.

Port of ``repro.launch.serve_online``. Stages the full online-deployment
story end-to-end and prints one JSON
report (the CI smoke parses it):

  phase A  — Poisson arrivals over the trained classes;
  fold 1   — labeled *drifted* feedback arrives mid-stream and folds
             through QAIL (``--drift``): same geometry, so the artifact
             swap is shape-stable and costs zero steady recompiles;
  phase B  — drifted arrivals served by generation 1;
  fold 2   — feedback labeled with a never-seen class
             (``--append-class``): the AM grows (D,C)->(D,C+1), the
             artifact re-packs through the deploy registry, the engine
             re-warms its bucket grid once (an excluded window);
  phase C  — arrivals including the appended class.

The engine's report is extended with per-phase accuracy and latency
(requests carry ground-truth labels for scoring only — the engine
itself is label-blind). ``recompiles_steady_state`` must print 0: every
kernel build (and graph capture) belongs to the warmup / fold / rewarm
windows. Folds run through the ``qail_update`` kernel on the GPU.

Examples (on the GPU; ``--device cpu`` for the plain path on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.serve_online --smoke
    PYTHONPATH=src python -m repro_torch.launch.serve_online --smoke \
        --append-class --target hierarchical
    PYTHONPATH=src python -m repro_torch.launch.serve_online --smoke \
        --append-class --devices 2 --device cpu

``--devices N`` serves through ``deploy.ShardedArtifact`` (N GPUs, or N
CPU shards with ``--device cpu``); each fold's new artifact is swapped
in through the wrapper's ``refresh``, which keeps its mesh.
``--record-dir DIR`` also writes the report as
``DIR/BENCH_serve_online.json`` (``obs.record``).
"""
from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs

log = logging.getLogger("serve_online")

# rid blocks per phase — keeps phase membership recoverable from the
# engine's flat response map.
RID_BLOCK = 100_000
PHASES = ("A", "B", "C")


def phase_stats(phase_idx: int, arrivals, engine) -> Dict:
    """Per-phase accuracy + latency summary from the engine's maps."""
    reqs = [a.request for a in arrivals]
    lats = [engine.request_lat_ms[r.rid] for r in reqs
            if r.rid in engine.request_lat_ms]
    hits = total = 0
    for r in reqs:
        pred = engine.responses.get(r.rid)
        if pred is None or r.labels is None:
            continue
        hits += int((np.asarray(pred) == np.asarray(r.labels)).sum())
        total += r.size
    misses = sum(
        1 for r in reqs
        if r.deadline_ms is not None and r.rid in engine.request_lat_ms
        and engine.request_lat_ms[r.rid] > r.deadline_ms)
    with_deadline = sum(1 for r in reqs if r.deadline_ms is not None
                        and r.rid in engine.request_lat_ms)
    return {
        "requests": len(reqs),
        "rows": sum(r.size for r in reqs),
        "accuracy": round(hits / total, 4) if total else None,
        "lat_ms_p50": (round(float(np.percentile(lats, 50)), 3)
                       if lats else None),
        "lat_ms_p99": (round(float(np.percentile(lats, 99)), 3)
                       if lats else None),
        "deadline_miss_rate": (round(misses / with_deadline, 4)
                               if with_deadline else None),
    }


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny training budget + short stream (CI-sized)")
    ap.add_argument("--requests", type=int, default=80,
                    help="requests per phase")
    ap.add_argument("--rate", type=float, default=300.0,
                    help="Poisson arrival rate (QPS)")
    ap.add_argument("--max-size", type=int, default=8,
                    help="max rows per request")
    ap.add_argument("--max-batch", type=int, default=128)
    ap.add_argument("--deadline-ms", type=float, default=250.0,
                    help="per-request latency budget (0 = best-effort)")
    ap.add_argument("--max-wait-ms", type=float, default=20.0,
                    help="batching policy's bounded-staleness cap")
    ap.add_argument("--target", default="packed",
                    choices=["packed", "unpacked", "imc", "hierarchical",
                             "multibit"])
    ap.add_argument("--fused", action="store_true",
                    help="serve through the fused feature pipeline")
    ap.add_argument("--devices", type=int, default=None,
                    help="serve through ShardedArtifact over N shards: "
                         "the first N GPUs, or N CPU shards with "
                         "--device cpu (default: no wrapper)")
    ap.add_argument("--depth", type=int, default=2,
                    help="double-buffer depth (batches in flight)")
    ap.add_argument("--fold-epochs", type=int, default=2,
                    help="QAIL epochs per feedback fold")
    ap.add_argument("--drift", type=float, default=0.35,
                    help="covariate-drift strength for fold 1 "
                         "(0 disables the drift phase)")
    ap.add_argument("--append-class", action="store_true",
                    help="hold out the last class at training time and "
                         "append it live via mid-stream feedback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events-out", default=None,
                    help="append-only JSONL event log (generation "
                         "swaps, serve start/end)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the obs metrics-registry snapshot here")
    ap.add_argument("--record-dir", default=None,
                    help="persist the report as BENCH_serve_online.json "
                         "(obs.record) in this directory")
    ap.add_argument("--log-json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    obs.setup_logging(json_mode=args.log_json)
    obs.install()

    from repro_torch import resolve_device
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    from repro_torch.serve import (
        OnlineEngine, StreamingUpdater, apply_drift, feedback_burst,
        merge_events, poisson_arrivals,
    )

    device = resolve_device(args.device)

    if args.smoke:
        args.requests = min(args.requests, 40)
    per_class = 80 if args.smoke else 300
    epochs = 2 if args.smoke else 10
    ds = load_dataset("mnist", train_per_class=per_class,
                      test_per_class=40, device="cpu")
    known = ds.classes - 1 if args.append_class else ds.classes
    tr_x, tr_y = ds.train_x.numpy(), ds.train_y.numpy()
    te_x, te_y = ds.test_x.numpy(), ds.test_y.numpy()
    mask = tr_y < known
    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = MemhdConfig(dim=128, columns=4 * known, classes=known,
                      epochs=epochs, kmeans_iters=5)
    model = MemhdModel.create(args.seed, enc, amc, device=device)
    model, _ = model.fit(args.seed + 1, tr_x[mask], tr_y[mask])
    log.info("trained on %d/%d classes (C=%d, D=%d)", known, ds.classes,
             amc.columns, amc.dim)

    deployed = model.deploy(target=args.target)
    if args.devices is not None:
        from repro_torch.launch.serve_memhd import shard
        deployed = shard(deployed, args.devices, device)
        log.info("sharded serving over %s", deployed.mesh)

    events_log = obs.EventLog(args.events_out)
    updater = StreamingUpdater(model, deployed,
                               fold_epochs=args.fold_epochs,
                               events=events_log)
    engine = OnlineEngine(updater, max_batch=args.max_batch,
                          depth=args.depth, fused=args.fused,
                          max_wait_ms=args.max_wait_ms,
                          events=events_log)

    deadline = args.deadline_ms or None
    kw = dict(rate_qps=args.rate, max_size=args.max_size,
              deadline_ms=deadline, labels_pool=te_y)
    drift = args.drift if args.drift > 0 else 0.0
    phases: Dict[str, List] = {}
    streams: List[List] = []

    # Phase A: clean arrivals over the trained classes.
    phases["A"] = poisson_arrivals(te_x, n_requests=args.requests,
                                   classes=range(known),
                                   seed=args.seed + 10, **kw)
    t = phases["A"][-1].t + 1e-3
    streams.append(phases["A"])

    # Fold 1: labeled drifted feedback -> shape-stable generation swap.
    if drift:
        streams.append(feedback_burst(
            apply_drift(tr_x[mask], drift), tr_y[mask], t=t, fold=True))
    pool_b = apply_drift(te_x, drift) if drift else te_x
    phases["B"] = poisson_arrivals(pool_b, n_requests=args.requests,
                                   classes=range(known), start=t,
                                   rid_base=RID_BLOCK,
                                   seed=args.seed + 11, **kw)
    t = phases["B"][-1].t + 1e-3
    streams.append(phases["B"])

    # Fold 2: feedback for a never-seen class -> grow + re-pack swap.
    if args.append_class:
        new = tr_y == known
        streams.append(feedback_burst(tr_x[new], tr_y[new], t=t,
                                      fold=True))
        phases["C"] = (
            poisson_arrivals(pool_b, n_requests=args.requests // 2,
                             classes=range(known), start=t,
                             rid_base=2 * RID_BLOCK,
                             seed=args.seed + 12, **kw)
            + poisson_arrivals(te_x, n_requests=args.requests // 2,
                               classes=[known], start=t,
                               rid_base=3 * RID_BLOCK,
                               seed=args.seed + 13, **kw))
        streams.append(phases["C"])

    report = engine.serve(merge_events(*streams))
    obs.update_memory_gauges()
    report = {
        "workload": "memhd_online_serve",
        "backend": deployed.backend,
        "devices": int(getattr(deployed, "n_devices", 1)),
        "device": str(device),
        "pipeline": "fused" if args.fused else "staged",
        "geometry": (f"{updater.model.am_cfg.dim}"
                     f"x{updater.model.am_cfg.columns}"),
        "classes": updater.model.am_cfg.classes,
        "scenario": {
            "drift": drift, "append_class": bool(args.append_class),
            "rate_qps": args.rate, "deadline_ms": deadline,
            "requests_per_phase": args.requests,
        },
        **report,
        "phases": {name: phase_stats(i, arr, engine)
                   for i, (name, arr) in enumerate(phases.items())},
    }
    print(json.dumps(report, indent=1))

    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(obs.snapshot(), f, indent=1)
        log.info("metrics snapshot -> %s", args.metrics_out)
    if args.record_dir:
        from repro_torch.obs import record
        path = record.from_report("serve_online", report,
                                  out_dir=args.record_dir, device=device)
        log.info("recorded -> %s", path)
    return report


if __name__ == "__main__":
    main()
