"""Host time of the packed serving path on one GPU, for a same-card A/B.

Builds a MEMHD model at f = 784, D = C = 1024 with a random AM from a
seed (the AM's values do not change the host's work), deploys it packed
and times, on the host clock:

* ``enqueue_us``: one ``predict`` (staged: encode, pack, search) and one
  ``predict_features`` (fused: encode_pack, search) call at B = 32 and
  B = 1024, enqueued back to back without a sync (the median over
  ``--reps`` runs of ``--calls`` calls each, divided by the calls);
* ``resolve_us``: where the checkout's ``ops`` reads the autotune cache,
  the host time of one memoised resolution of a dispatch's tile (the
  packed search's and the encode's, at B = 1024; null otherwise);
* ``serve``: ``serve_batches`` over 256 ragged requests of at most 32
  rows (the stream ``chip_smoke.py`` serves) at ``max_batch`` 1024,
  depth 2, staged and fused: wall seconds and rows/s, median over the
  runs.

It uses only the serving surface that every version of the port has, so
one copy of the script times any checkout:

    PYTHONPATH=<checkout>/src python3 tools/serve_host_time.py --label A

prints one JSON line. Run parent, change, change, parent in one call on
the same card and compare within it.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_host_time.py needs a GPU")

    import repro_torch
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.core import am as am_lib
    from repro_torch.launch import serve_memhd as sm

    dev = torch.device("cuda", 0)
    f, d, c, classes = 784, 1024, 1024, 10
    enc = EncoderConfig(kind="projection", features=f, dim=d)
    amc = MemhdConfig(dim=d, columns=c, classes=classes)
    model = MemhdModel.create(args.seed, enc, amc, device=dev)
    rng = np.random.default_rng(args.seed)
    fp = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                         device=dev)
    owners = torch.as_tensor(np.arange(c) % classes, dtype=torch.int32,
                             device=dev)
    model = dataclasses.replace(model, am_state=am_lib.make_am_state(
        fp, owners, amc.threshold))
    dep = model.deploy(target="packed")
    # Features on a 2^-8 grid, as the served stream's.
    x = np.round(rng.random((4096, f), dtype=np.float32) * 256) / 256
    reqs = [sm.Request(i, x[o:o + n]) for i, (o, n) in enumerate(zip(
        rng.integers(0, 4096 - 32, 256), rng.integers(1, 33, 256)))]

    enqueue = {}
    for b in (32, 1024):
        xb = torch.as_tensor(x[:b], device=dev)
        for name in ("predict", "predict_features"):
            fn = getattr(dep, name)
            for _ in range(3):
                fn(xb)
            torch.cuda.synchronize()
            per_call = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn(xb)
                per_call.append((time.perf_counter() - t0) / args.calls)
                torch.cuda.synchronize()
            enqueue[f"{name}_b{b}"] = statistics.median(per_call) * 1e6

    resolve = None
    if importlib.util.find_spec("repro_torch.kernels.autotune") is not None:
        from repro_torch.kernels import ops
        xb = torch.as_tensor(x[:1024], device=dev)
        resolve = {}
        for name, fn in (
                ("packed", lambda: ops._packed_block_b(None, xb, "popcount",
                                                       d, c)),
                ("encode", lambda: ops._encode_tile(xb, f, d))):
            fn()
            per_call = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                for _ in range(1000):
                    fn()
                per_call.append((time.perf_counter() - t0) / 1000)
            resolve[name] = statistics.median(per_call) * 1e6

    serve = {}
    rows = sum(r.size for r in reqs)
    for fused in (False, True):
        sm.serve_batches(dep, reqs, max_batch=1024, depth=2, fused=fused)
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            sm.serve_batches(dep, reqs, max_batch=1024, warmup=False,
                             depth=2, fused=fused)
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls)
        serve["fused" if fused else "staged"] = {
            "wall_ms": wall * 1e3, "rows_per_s": rows / wall,
            "wall_ms_min": min(walls) * 1e3}

    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"label": args.label, "package": repro_torch.__file__,
           "gpu": gpu, "rows": rows, "requests": len(reqs),
           "enqueue_us": enqueue, "resolve_us": resolve, "serve": serve}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
