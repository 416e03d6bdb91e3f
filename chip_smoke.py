#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed on its own line(s); any failure raises and the
script exits non-zero without the final result line:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. the build: nvcc compiles the five kernel sources of ``src/repro_torch/
   kernels/csrc`` for sm_90a, one process each, all at once (timed, with
   ptxas' register report);
2. each kernel against its plain PyTorch version on the card, over the
   differential geometry grid, tie and padding cases and the full-width
   shapes: ``pack_bits``, ``am_search_packed`` (both modes, every block
   size) and ``am_search`` bit-exact; ``encode_pack`` bit-exact on dyadic
   features and within the stated tolerance on float features;
   ``qail_update`` (every block size) bit-exact in its targets, misses
   and (at a dyadic lr and payload) its delta, and within |delta error|
   <= 2^-20 * sum|terms| at lr = 0.02;
3. the main path at the paper's widest MNIST point (f = 784, D = C =
   1024, R = 0.8, lr = 0.02, batch 256, 25 k-means iterations) on the
   full synthetic MNIST: ``MemhdModel.create`` -> ``fit`` ->
   ``deploy(target="packed")`` -> ``serve_batches`` staged and fused at
   depth 2; kernel launch counts are zeroed just before and read just
   after, and staged == fused == the plain ``MemhdModel.predict`` bit for
   bit on dyadic-rounded test features;
4. the training path, same model and seeds: ``fit(use_kernel=True)``
   (every minibatch one ``qail_update`` launch, 235 x 100) -> the
   trained AM deployed three ways (``target="unpacked"``,
   ``target="packed", mode="unpack"``, ``target="packed"``) -> the same
   request stream served through each; launch counts zeroed just before
   and read just after; the kernel fit's binary AM agrees with the plain
   fit's on >= 99.9 % of cells and its test accuracy within 0.005; all
   pipelines and the plain predict agree on every request, and no
   dispatch fell back to the plain tier;
5. the kernel fit against the plain fit under dyadic conditions
   (features on a 2^-4 grid, lr = 2^-4): ``fp``, ``binary`` and every
   epoch's miss bit-equal, at D = C = 128 and at full width, 10 epochs;
6. the serving CLI: staged, ``--fused``, ``--target unpacked`` and
   ``--mode unpack``;
7. the trainer CLI (``repro_torch.launch.train --arch memhd --smoke
   --steps 10``): a run killed at step 7 (exit 42), its resume and a
   clean run give the same ``am_digest``, on the card and on the CPU;
8. reproducibility: two 128 x 128 fits from the same seeds agree, plain
   and through the ``qail_update`` kernel;
9. the ``kernels`` line: launches on the paths, device time, the plain
   version's time and the bound of each kernel at the paths' shapes
   (``qail_update`` also on random targets, where most rows miss).

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth,
# the fp32 rate outside the tensor cores and the int8 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
# Hopper issues __popc at 16 results per clock per SM (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute 9.0).
POPC_PER_CLK_PER_SM = 16

# Differential grid (batch, features, dim, columns): the reference's
# tests/test_kernel_parity.py GEOMS, plus Dp = 13 (D = 100, not a
# multiple of 4 bytes) and the main path's full width.
GEOMS = [(1, 16, 128, 128), (8, 784, 128, 128), (3, 100, 130, 257),
         (5, 617, 512, 300), (2, 64, 120, 26), (1, 9, 9, 3),
         (4, 32, 100, 50)]
FULL = (1024, 784, 1024, 1024)
TRAIN_B = 256  # the QAIL minibatch: qail_update's full-width shape
EPOCHS = 100  # the paper's QAIL epochs: the main path runs them uncut
DYADIC_EPOCHS = 10
DYADIC_WIDTHS = (128, 1024)  # D = C: misses stay high at 128 (PERF.md)
MAIN_KERNELS = ("pack_bits", "am_search_packed", "encode_pack")
NEW_KERNELS = ("qail_update", "am_search", "am_search_packed_unpack")
TRAINER_DEVICES = ("cuda", "cpu")


def check(cond, what) -> None:
    """Fail the run (assert statements vanish under python -O)."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_device_ms(fn, samples: int = 21, calls: int = 10) -> float:
    """Median device time of one call, in ms.

    Each sample parks the stream behind ``torch.cuda._sleep`` while the
    host enqueues ``calls`` calls, so the events bracket back-to-back
    device work and not the host's launch overhead."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Smoke:
    def __init__(self):
        import numpy as np
        import torch
        self.np, self.torch = np, torch
        self.dev = torch.device("cuda")
        self.max_err = {"pack_bits": 0.0, "am_search_packed": 0.0,
                        "encode_pack": 0.0, "qail_update": 0.0,
                        "am_search": 0.0, "am_search_packed_unpack": 0.0}

    # -- helpers ---------------------------------------------------------------
    def t(self, a):
        return self.torch.as_tensor(a, device=self.dev)

    def bipolar(self, rng, shape):
        return self.t(rng.choice([-1.0, 1.0], size=shape).astype("float32"))

    def feats(self, rng, b, f, dyadic):
        x = rng.random((b, f), dtype=self.np.float32)
        if dyadic:
            x = self.np.round(x * 256) / 256
        return self.t(x.astype("float32"))

    # -- phase 1 ---------------------------------------------------------------
    def build(self):
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        path = _build.build()
        _build.lib()
        regs = [ln.strip() for ln in _build.build_log.splitlines()
                if "Used" in ln or "Compiling entry" in ln]
        log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
             "library": os.path.relpath(str(path), HERE), "ptxas": regs})

    # -- phase 2 ---------------------------------------------------------------
    def check_kernels(self):
        np, torch = self.np, self.torch
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import encode_fused, pack_bits, ref
        rows = []
        for geom in GEOMS + [FULL]:
            b, f, d, c = geom
            full = geom == FULL
            rng = np.random.default_rng([1234, b, f, d, c])
            # pack_bits on byte-aligned rows, pack_rows on any D.
            x = self.bipolar(rng, (b, -(-d // 8) * 8))
            got, want = pack_bits.pack_bits(x), ref.pack_bits(x)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            xr = self.bipolar(rng, (b, d))
            check(torch.equal(asp.pack_rows(xr), ref.pack_rows(xr)), geom)
            check(err == 0, ("pack_bits", geom, err))
            if full:
                self.max_err["pack_bits"] = float(err)
            # am_search_packed: random AM, then an AM of duplicated
            # columns so every query's maximum is tied.
            q = ref.pack_rows(self.bipolar(rng, (b, d)))
            am = self.bipolar(rng, (c, d))
            dup = am[torch.arange(c, device=self.dev) % max(1, c // 3)]
            for a in (am, dup):
                am_t = ref.pack_rows(a).T.contiguous()
                w_idx, w_sim = ref.am_search_packed(q, am_t, d)
                for bb in asp.BLOCK_B_CHOICES:
                    idx, sim = asp.am_search_packed(q, am_t, n_dims=d,
                                                    block_b=bb)
                    torch.cuda.synchronize()
                    check(torch.equal(idx, w_idx), ("am_search", geom, bb))
                    err = (sim - w_sim).abs().max().item()
                    check(err == 0, ("am_search sim", geom, bb, err))
                    if full:
                        self.max_err["am_search_packed"] = max(
                            self.max_err["am_search_packed"], err)
            # encode_pack: bit-exact on dyadic features...
            proj = self.bipolar(rng, (f, d))
            xd = self.feats(rng, b, f, dyadic=True)
            got = encode_fused.encode_pack(xd, proj)
            want = ref.encode_pack(xd, proj)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            check(err == 0, ("encode_pack dyadic", geom, err))
            if full:
                self.max_err["encode_pack"] = float(err)
            # ... and on float features a sign bit may differ only where
            # |H| <= 1e-5 * sum|x| (fp32 summation-order rounding).
            xf = self.feats(rng, b, f, dyadic=False)
            h = xf @ proj
            gb = ref.unpack_bits(encode_fused.encode_pack(xf, proj))[:, :d]
            wb = ref.unpack_bits(ref.encode_pack(xf, proj))[:, :d]
            diff = gb != wb
            tol = 1e-5 * xf.abs().sum(dim=1, keepdim=True)
            outside = (diff & (h.abs() > tol)).sum().item()
            check(outside == 0, ("encode_pack float", geom, outside))
            rows.append({"geom": geom, "encode_pack_float_flips":
                         int(diff.sum().item()),
                         **self.check_new_kernels(rng, geom)})
        log({"phase": "kernels_vs_plain", "ok": True, "grid": rows,
             "max_abs_err_full_width": self.max_err})

    def check_new_kernels(self, rng, geom):
        """am_search, the unpack mode and qail_update at one geometry
        (qail_update at (TRAIN_B, D, C) for the full width)."""
        torch = self.torch
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import ref
        b, f, d, c = geom
        full = geom == FULL
        am = self.bipolar(rng, (c, d))
        dup = am[torch.arange(c, device=self.dev) % max(1, c // 3)]
        for a in (am, dup):
            # am_search: ±1 and dyadic float queries, through the (D, C)
            # transposed view of the resident (C, D) AM and a copy.
            for q in (self.bipolar(rng, (b, d)),
                      self.feats(rng, b, d, dyadic=True) - 0.5):
                w_idx, w_sim = ref.am_search(q, a.T)
                for am_t in (a.T, a.T.contiguous()):
                    idx, sim = ams.am_search(q, am_t)
                    torch.cuda.synchronize()
                    err = (sim - w_sim).abs().max().item()
                    check(torch.equal(idx, w_idx) and err == 0,
                          ("am_search", geom, err))
                    if full:
                        self.max_err["am_search"] = max(
                            self.max_err["am_search"], err)
            # the unpack mode of the packed search, every block size.
            qp = ref.pack_rows(self.bipolar(rng, (b, d)))
            am_t = ref.pack_rows(a).T.contiguous()
            w_idx, w_sim = ref.am_search_packed_unpack(qp, am_t, d)
            p_idx, p_sim = ref.am_search_packed(qp, am_t, d)
            check(torch.equal(w_idx, p_idx) and torch.equal(w_sim, p_sim),
                  ("unpack plain == popcount plain", geom))
            for bb in asp.BLOCK_B_CHOICES:
                idx, sim = asp.am_search_packed(qp, am_t, n_dims=d,
                                                block_b=bb, mode="unpack")
                torch.cuda.synchronize()
                err = (sim - w_sim).abs().max().item()
                check(torch.equal(idx, w_idx) and err == 0,
                      ("unpack", geom, bb, err))
                if full:
                    self.max_err["am_search_packed_unpack"] = max(
                        self.max_err["am_search_packed_unpack"], err)
        # qail_update: padded last row, a class that owns no centroid,
        # ties (duplicated AM columns), a dyadic and a float payload.
        qb = TRAIN_B if full else b
        out = {}
        for tie in (False, True):
            for dyadic in (True, False):
                err, rel = self.check_qail(rng, qb, d, c, tie, dyadic)
                out[f"qail_{'tie' if tie else 'rand'}_"
                    f"{'dyadic' if dyadic else 'lr0.02'}_max_err"] = err
                out.setdefault("qail_max_err_over_tol", 0.0)
                out["qail_max_err_over_tol"] = max(
                    out["qail_max_err_over_tol"], rel)
                if full and not dyadic:
                    self.max_err["qail_update"] = max(
                        self.max_err["qail_update"], err)
        return out

    def qail_operands(self, rng, b, d, c, tie, dyadic):
        """Random qail_update operands: random targets (most rows miss), a
        padded last row, a class that owns no centroid, ties (duplicated
        AM columns) if ``tie``; a dyadic payload and lr = 2^-4, or a float
        payload and lr = 0.02. Returns (q, upd, am_t, owners, labels,
        mask, lr)."""
        np, torch = self.np, self.torch
        k = max(2, c // 3)
        am_t = self.bipolar(rng, (d, c))
        if tie:
            am_t = am_t[:, torch.arange(c, device=self.dev) % max(1, c // 3)]
        q = self.bipolar(rng, (b, d))
        owners = self.t(rng.integers(0, k, c).astype(np.int32))
        labels = rng.integers(0, k + 1, b).astype(np.int32)  # k: no owner
        mask = (rng.random(b) > 0.2).astype(np.float32)
        labels[-1], mask[-1] = -1, 0.0  # a padded row
        labels, mask = self.t(labels), self.t(mask)
        if dyadic:  # 2^-4 grid, |upd| < 2^10, lr 2^-4: exact partial sums
            upd = np.round(np.clip(rng.normal(0, 64, (b, d)), -1000, 1000)
                           * 16) / 16
            lr = 0.0625
        else:
            upd, lr = rng.normal(0, 8, (b, d)), 0.02
        return (q, self.t(upd.astype(np.float32)), am_t, owners, labels,
                mask, lr)

    def check_qail(self, rng, b, d, c, tie, dyadic):
        """qail_update at every block size against its plain version.
        Returns the max |delta error| and the max of |error| / tolerance."""
        torch = self.torch
        from repro_torch.kernels import qail_update as qu
        from repro_torch.kernels import ref
        q, upd, am_t, owners, labels, mask, lr = self.qail_operands(
            rng, b, d, c, tie, dyadic)
        w_pred, w_true, w_mis = ref.qail_targets(q, am_t, owners, labels,
                                                 mask)
        w_delta, w_miss = ref.qail_delta(upd, w_pred, w_true, w_mis, lr, c)
        w = (lr * w_mis)[:, None] * (
            torch.nn.functional.one_hot(w_true, c)
            - torch.nn.functional.one_hot(w_pred, c)).float()
        tol = 2.0 ** -20 * (w.abs().T @ upd.abs())
        max_err = max_rel = 0.0
        for bb in qu.BLOCK_B_CHOICES:
            delta, n_miss, pred_t, true_t, mis = qu.qail_update_targets(
                q, upd, am_t, owners, labels, mask, lr=lr, block_b=bb)
            torch.cuda.synchronize()
            geom = (b, d, c, tie, dyadic, bb)
            check(torch.equal(pred_t.long(), w_pred), ("qail pred_t", geom))
            check(torch.equal(true_t.long(), w_true), ("qail true_t", geom))
            check(torch.equal(mis, w_mis), ("qail mis", geom))
            check(n_miss.item() == w_miss.item(), ("qail n_miss", geom))
            err = (delta - w_delta).abs()
            if dyadic:
                check(err.max().item() == 0, ("qail delta dyadic", geom))
            rel = (err / tol.clamp_min(1e-30)).max().item()
            check((err <= tol).all().item(), ("qail delta", geom, rel))
            max_err = max(max_err, err.max().item())
            max_rel = max(max_rel, rel)
        return max_err, max_rel

    # -- phase 3 ---------------------------------------------------------------
    def main_path(self):
        np, torch = self.np, self.torch
        from repro_torch import kernels
        from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
        from repro_torch.data import load_dataset
        from repro_torch.launch import serve_memhd as sm

        t0 = time.perf_counter()
        ds = load_dataset("mnist", device=self.dev)
        n_train, n_test = ds.train_x.shape[0], ds.test_x.shape[0]
        t_data = time.perf_counter() - t0
        enc = EncoderConfig(kind="projection", features=784, dim=1024)
        amc = MemhdConfig(dim=1024, columns=1024, classes=10,
                          init_ratio=0.8, lr=0.02, batch_size=256,
                          kmeans_iters=25, epochs=EPOCHS)
        log({"phase": "main_path_config", "features": 784, "dim": 1024,
             "columns": 1024, "init_ratio": 0.8, "lr": 0.02,
             "batch_size": 256, "kmeans_iters": 25,
             "epochs": EPOCHS,
             "train": n_train, "test": n_test,
             "data_seconds": round(t_data, 3)})
        test_dy = np.round(ds.test_x.cpu().numpy() * 256) / 256
        test_dy = test_dy.astype(np.float32)
        reqs = sm.synthetic_requests(test_dy, 256, 32, seed=0)

        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = MemhdModel.create(0, enc, amc, device=self.dev)
        model, hist = model.fit(1, ds.train_x, ds.train_y)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        deployed = model.deploy(target="packed")
        reports, responses = {}, {}
        for fused in (False, True):
            # A warm pass runs every padded shape once; the timed pass is
            # the report, as in the serving CLI.
            sm.serve_batches(deployed, reqs, max_batch=1024, fused=fused,
                             depth=2)
            t0 = time.perf_counter()
            resp, stats = sm.serve_batches(deployed, reqs, max_batch=1024,
                                           warmup=False, fused=fused,
                                           depth=2)
            wall = time.perf_counter() - t0
            key = "fused" if fused else "staged"
            responses[key] = resp
            reports[key] = sm.build_report(deployed, reqs, stats, wall,
                                           fused=fused)
        torch.cuda.synchronize()
        launches = kernels.launches()
        self.launches = launches

        for name in MAIN_KERNELS:
            check(launches[name] > 0,
                  f"{name} was not launched on the main path")
        for r in reqs:
            plain = model.predict(self.t(r.feats)).cpu().numpy()
            check(np.array_equal(responses["staged"][r.rid],
                                 responses["fused"][r.rid]), r.rid)
            check(np.array_equal(responses["staged"][r.rid], plain), r.rid)
        acc_packed = deployed.score(ds.test_x, ds.test_y)
        acc_plain = model.score(ds.test_x, ds.test_y)
        check(acc_packed == acc_plain, (acc_packed, acc_plain))
        check(acc_packed > 0.5, acc_packed)
        log({"phase": "main_path", "fit_seconds": round(t_fit, 3),
             "init_rounds": len(hist["init"]),
             "final_train_miss": hist["curve"][-1]["train_miss"],
             "test_accuracy_packed": acc_packed,
             "test_accuracy_plain": acc_plain,
             "staged_eq_fused_eq_plain": True, "launches": launches})
        for key, rep in reports.items():
            log({"phase": f"serve_report_{key}", **rep})
        for fused in (False, True):
            self.profile_serving(deployed, reqs, fused)
        self.model, self.deployed, self.ds = model, deployed, ds
        self.enc, self.amc, self.reqs = enc, amc, reqs
        self.plain_fit = {"seconds": t_fit, "acc": acc_plain,
                          "miss": [r["train_miss"] for r in hist["curve"]]}

    def profile(self, phase, fn, **labels):
        """Device-busy share and the kernels that take the device time of
        one call of ``fn`` (torch.profiler, CUDA activity)."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # Device-side events only (kernels, memcpys): the CPU op that
        # launched a kernel also reports its device time.
        rows = [(ev.self_device_time_total, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        log({"phase": phase, **labels,
             "wall_us_profiled": round(wall_us, 1),
             "device_busy_us": round(busy_us, 1),
             "device_busy_share": round(busy_us / wall_us, 4),
             "top_device_ops": [{"op": k[:80], "us": round(u, 1), "count": c}
                                for u, k, c in rows[:8]]})

    def profile_serving(self, deployed, reqs, fused):
        from repro_torch.launch import serve_memhd as sm
        self.profile("serve_profile", lambda: sm.serve_batches(
            deployed, reqs, max_batch=1024, warmup=False, fused=fused,
            depth=2), pipeline="fused" if fused else "staged")

    # -- phase 4 ---------------------------------------------------------------
    def train_path(self):
        """fit(use_kernel=True) -> three deployments -> serve, with the
        launch counts zeroed just before and read just after."""
        np, torch = self.np, self.torch
        from repro_torch import kernels
        from repro_torch.core import MemhdModel
        from repro_torch.kernels import ops
        from repro_torch.launch import serve_memhd as sm
        ds, reqs = self.ds, self.reqs

        kernels.reset_launches()
        ops.reset_dispatch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = MemhdModel.create(0, self.enc, self.amc, device=self.dev)
        model, hist = model.fit(1, ds.train_x, ds.train_y, use_kernel=True)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        n_batches = -(-ds.train_x.shape[0] // self.amc.batch_size)
        fit_launches = kernels.launches()["qail_update"]
        check(fit_launches == n_batches * EPOCHS,
              ("qail_update launches", fit_launches, n_batches * EPOCHS))

        targets = {"unpacked": dict(target="unpacked"),
                   "packed_unpack": dict(target="packed", mode="unpack"),
                   "packed_popcount": dict(target="packed")}
        reports, responses = {}, {}
        for name, kw in targets.items():
            dep = model.deploy(**kw)
            for fused in ((False,) if name == "unpacked" else (False, True)):
                sm.serve_batches(dep, reqs, max_batch=1024, fused=fused,
                                 depth=2)
                t0 = time.perf_counter()
                resp, stats = sm.serve_batches(dep, reqs, max_batch=1024,
                                               warmup=False, fused=fused,
                                               depth=2)
                wall = time.perf_counter() - t0
                key = f"{name}_{'fused' if fused else 'staged'}"
                responses[key] = resp
                reports[key] = sm.build_report(dep, reqs, stats, wall,
                                               fused=fused)
            acc = dep.score(ds.test_x, ds.test_y)
            reports[name + "_accuracy"] = acc
        torch.cuda.synchronize()
        launches = kernels.launches()
        tiers = ops.dispatch_breakdown()
        self.train_launches = launches

        for name in NEW_KERNELS:
            check(launches[name] > 0, f"{name} was not launched on the "
                                      "training path")
        check("torch-ref" not in json.dumps(tiers), tiers)
        for r in reqs:
            plain = model.predict(self.t(r.feats)).cpu().numpy()
            for key, resp in responses.items():
                check(np.array_equal(resp[r.rid], plain), (key, r.rid))
        acc_kernel = model.score(ds.test_x, ds.test_y)
        for name in targets:
            check(reports[name + "_accuracy"] == acc_kernel,
                  (name, reports[name + "_accuracy"], acc_kernel))
        agree = (model.am_state["binary"]
                 == self.model.am_state["binary"]).float().mean().item()
        check(agree >= 0.999, ("binary AM agreement", agree))
        check(abs(acc_kernel - self.plain_fit["acc"]) <= 0.005,
              (acc_kernel, self.plain_fit["acc"]))
        log({"phase": "train_path",
             "fit_seconds_kernel": round(t_fit, 3),
             "fit_seconds_plain": round(self.plain_fit["seconds"], 3),
             "qail_update_launches_in_fit": fit_launches,
             "miss_curve_kernel": [r["train_miss"] for r in hist["curve"]],
             "miss_curve_plain": self.plain_fit["miss"],
             "test_accuracy_kernel": acc_kernel,
             "test_accuracy_plain": self.plain_fit["acc"],
             "binary_am_agreement": agree,
             "fp_max_abs_diff": (model.am_state["fp"]
                                 - self.model.am_state["fp"]
                                 ).abs().max().item(),
             "launches": launches, "dispatch_tiers": tiers})
        log({"phase": "unpacked_serving",
             "pipelines_eq_plain_predict": sorted(responses),
             "accuracy": {k[:-len("_accuracy")]: v for k, v in
                          reports.items() if k.endswith("_accuracy")}})
        for key, rep in reports.items():
            if not key.endswith("_accuracy"):
                log({"phase": f"serve_report_{key}", **rep})
        self.kmodel = model
        self.profile_training(model)

    def profile_training(self, model):
        """One QAIL epoch of the trained model, through the kernel and
        plain, under the profiler (device busy share, top kernels)."""
        from repro_torch.core import encoding, qail
        h = model.encode(self.ds.train_x)
        batches = qail.prebatch(h, encoding.binarize_query(h),
                                self.ds.train_y, self.amc.batch_size)
        for use_kernel in (True, False):
            self.profile("train_profile", lambda: qail.qail_epoch_scan(
                dict(model.am_state), self.amc, *batches,
                use_kernel=use_kernel),
                route="kernel" if use_kernel else "plain",
                batches=int(batches[0].shape[0]))

    # -- phase 5 ---------------------------------------------------------------
    def train_dyadic(self):
        """The kernel fit and the plain fit bit-equal under dyadic
        conditions: features on a 2^-4 grid and lr = 2^-4 make every
        Eq.-(6) partial sum exact (|h| <= 784 on a 2^-4 grid, times lr:
        22 significant bits over a 256-row batch)."""
        import dataclasses
        torch = self.torch
        from repro_torch.core import EncoderConfig, MemhdModel
        x = torch.round(self.ds.train_x * 16) / 16
        out = []
        for width in DYADIC_WIDTHS:
            enc = EncoderConfig(kind="projection", features=784, dim=width)
            amc = dataclasses.replace(self.amc, dim=width, columns=width,
                                      lr=0.0625, epochs=DYADIC_EPOCHS)
            fits = {}
            for use_kernel in (True, False):
                t0 = time.perf_counter()
                m = MemhdModel.create(0, enc, amc, device=self.dev)
                m, hist = m.fit(1, x, self.ds.train_y, use_kernel=use_kernel)
                torch.cuda.synchronize()
                fits[use_kernel] = (m.am_state,
                                    [r["train_miss"] for r in hist["curve"]],
                                    time.perf_counter() - t0)
            (k_am, k_miss, k_s), (p_am, p_miss, p_s) = fits[True], fits[False]
            for key in ("fp", "binary"):
                check(torch.equal(k_am[key], p_am[key]),
                      ("dyadic fit", width, key))
            check(k_miss == p_miss, ("dyadic miss curve", width))
            out.append({"dim": width, "columns": width,
                        "epochs": DYADIC_EPOCHS, "fp_equal": True,
                        "binary_equal": True, "miss_equal": True,
                        "miss_curve": k_miss,
                        "fit_seconds_kernel": round(k_s, 3),
                        "fit_seconds_plain": round(p_s, 3)})
        log({"phase": "train_dyadic", "fits": out})

    # -- phase 6 ---------------------------------------------------------------
    def cli(self):
        from repro_torch.launch import serve_memhd as sm
        base = ["--smoke", "--requests", "32", "--max-size", "24",
                "--max-batch", "128"]
        for extra in ([], ["--fused"], ["--target", "unpacked"],
                      ["--mode", "unpack"]):
            rep = sm.main(base + extra)
            tiers = rep["metrics"]["dispatch_tiers"]
            check("torch-ref" not in json.dumps(tiers), tiers)
            log({"phase": "cli", "args": base + extra, "ok": True})

    # -- phase 7 ---------------------------------------------------------------
    def trainer(self):
        """The trainer CLI killed at step 7, resumed, and run clean: the
        resumed and the clean run end on the same binary AM."""
        env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
        build = os.path.join(HERE, "build")
        os.makedirs(build, exist_ok=True)
        out = {}
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            for device in TRAINER_DEVICES:
                def run(name, *extra):
                    cmd = [sys.executable, "-m", "repro_torch.launch.train",
                           "--arch", "memhd", "--smoke", "--steps", "10",
                           "--ckpt-every", "5", "--device", device,
                           "--ckpt-dir", os.path.join(tmp, device, name),
                           *extra]
                    return subprocess.run(cmd, env=env, capture_output=True,
                                          text=True, timeout=300)

                def result(p):
                    check(p.returncode == 0, p.stderr[-2000:])
                    return json.loads(p.stdout[p.stdout.index("{"):])

                t0 = time.perf_counter()
                crash = run("crash", "--fail-at-step", "7")
                check(crash.returncode == 42, ("crash exit", crash.returncode,
                                               crash.stderr[-2000:]))
                resumed = result(run("crash"))
                clean = result(run("clean"))
                check(resumed["resumed_from"] == 5, resumed)
                check(resumed["am_digest"] == clean["am_digest"],
                      (device, resumed["am_digest"], clean["am_digest"]))
                out[device] = {"am_digest": clean["am_digest"],
                               "resumed_from": resumed["resumed_from"],
                               "eval_acc": clean["eval_acc"],
                               "last_miss": clean["last_miss"],
                               "seconds_three_runs":
                                   round(time.perf_counter() - t0, 3)}
        digests = {v["am_digest"] for v in out.values()}
        log({"phase": "trainer", "crash_exit": 42, **out,
             "same_digest_on_every_device": len(digests) == 1})

    # -- phase 8 ---------------------------------------------------------------
    def reproducibility(self):
        torch = self.torch
        from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
        from repro_torch.data import load_dataset
        ds = load_dataset("mnist", train_per_class=300, test_per_class=50,
                          device=self.dev)
        enc = EncoderConfig(kind="projection", features=784, dim=128)
        amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=5,
                          kmeans_iters=10)
        rec = {"phase": "reproducibility"}
        for use_kernel in (False, True):
            ams = []
            for _ in range(2):
                m = MemhdModel.create(3, enc, amc, device=self.dev)
                m, _ = m.fit(4, ds.train_x, ds.train_y,
                             use_kernel=use_kernel)
                ams.append(m.am_state)
            same_bin = torch.equal(ams[0]["binary"], ams[1]["binary"])
            same_fp = torch.equal(ams[0]["fp"], ams[1]["fp"])
            check(same_bin and same_fp, (use_kernel, same_bin, same_fp))
            key = "kernel" if use_kernel else "plain"
            rec[f"{key}_binary_equal"] = same_bin
            rec[f"{key}_fp_equal"] = same_fp
        log(rec)

    # -- phase 9 ---------------------------------------------------------------
    def kernel_line(self):
        np, torch = self.np, self.torch
        from repro_torch.core import encoding
        from repro_torch.kernels import am_search as ams
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import encode_fused, pack_bits, qail_update
        from repro_torch.kernels import ref

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clk_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        popc_rate = sms * POPC_PER_CLK_PER_SM * clk_mhz * 1e6
        b, f, d, c = FULL
        feats = self.t(self.np.round(
            self.ds.test_x[:b].cpu().numpy() * 256) / 256)
        proj = self.model.enc_params["projection"]
        q = encoding.encode_query(self.model.enc_params,
                                  self.model.enc_cfg, feats)
        qp = ref.pack_rows(q)
        am_t = self.deployed.am_packed_t
        dp = qp.shape[1]

        def bound(nbytes, ops, rate):
            tb, to = nbytes / HBM_BYTES_PER_S, ops / rate
            return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"

        # The training path's shapes: one minibatch of the kernel fit's
        # prebatched data against its final binary AM (a (D, C) view).
        km = self.kmodel
        h = km.encode(self.ds.train_x[:TRAIN_B])
        tq = encoding.binarize_query(h)
        ty = self.ds.train_y[:TRAIN_B].to(torch.int32)
        tmask = torch.ones(TRAIN_B, device=self.dev)
        tam_t = km.am_state["binary"].T
        owners = km.am_state["centroid_class"]
        lr = self.amc.lr
        am_binary = km.am_state["binary"]
        kqp = ref.pack_rows(encoding.encode_query(km.enc_params, km.enc_cfg,
                                                  feats))
        kam_t = km.deploy(target="packed").am_packed_t

        cases = [
            ("pack_bits", "src/repro_torch/kernels/csrc/pack_bits.cu",
             "src/repro/kernels/pack_bits.py:43",
             lambda: pack_bits.pack_bits(q), lambda: ref.pack_bits(q),
             bound(q.numel() * 4 + q.numel() // 8, q.numel(),
                   FP32_FLOP_PER_S)),
            # Both packed modes: the Hamming search of packed bits is, on
            # ±1/0 operands that are exact in int8, a 2*B*C*D-op int8
            # product at the tensor-core rate: a lower bound than the
            # 32-bit popcount count at the popc rate (logged in "rates").
            ("am_search_packed",
             "src/repro_torch/kernels/csrc/am_search_packed.cu",
             "src/repro/kernels/am_search_packed.py:167",
             lambda: asp.am_search_packed(qp, am_t, n_dims=d),
             lambda: ref.am_search_packed(qp, am_t, d),
             bound(qp.numel() + am_t.numel() + 8 * b, 2 * b * c * d,
                   INT8_OPS_PER_S)),
            ("encode_pack", "src/repro_torch/kernels/csrc/encode_pack.cu",
             "src/repro/kernels/encode_fused.py:97",
             lambda: encode_fused.encode_pack(feats, proj),
             lambda: ref.encode_pack(feats, proj),
             bound(feats.numel() * 4 + proj.numel() * 4 + b * dp,
                   2 * b * f * d, FP32_FLOP_PER_S)),
            ("qail_update", "src/repro_torch/kernels/csrc/qail_update.cu",
             "src/repro/kernels/qail_update.py:97",
             lambda: qail_update.qail_update(tq, h, tam_t, owners, ty,
                                             tmask, lr=lr),
             lambda: ref.qail_update_delta(tq, h, tam_t, owners, ty, tmask,
                                           lr),
             bound(4 * (2 * TRAIN_B * d + d * c + c + 2 * TRAIN_B + c * d
                        + 1), 2 * TRAIN_B * c * d, FP32_FLOP_PER_S)),
            ("am_search", "src/repro_torch/kernels/csrc/am_search.cu",
             "src/repro/kernels/am_search.py:88",
             lambda: ams.am_search(q, am_binary.T),
             lambda: ref.am_search(q, am_binary.T),
             bound(4 * (b * d + d * c + 2 * b), 2 * b * c * d,
                   FP32_FLOP_PER_S)),
            ("am_search_packed_unpack",
             "src/repro_torch/kernels/csrc/am_search_packed.cu",
             "src/repro/kernels/am_search_packed.py:167",
             lambda: asp.am_search_packed(kqp, kam_t, n_dims=d,
                                          mode="unpack"),
             lambda: ref.am_search_packed_unpack(kqp, kam_t, d),
             bound(kqp.numel() + kam_t.numel() + 8 * b, 2 * b * c * d,
                   INT8_OPS_PER_S)),
        ]
        out = []
        for name, src, replaces, kern, plain, (bound_ms, bound_by) in cases:
            ms = time_device_ms(kern)
            plain_ms = time_device_ms(plain, samples=21, calls=2)
            launches = (self.train_launches if name in NEW_KERNELS
                        else self.launches)[name]
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches,
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
        # qail_update once more on random targets at the training shape:
        # the trained AM's batch above has no misses, so there the delta
        # pass adds nothing. The bound is the same (sims dominate).
        rq = self.qail_operands(np.random.default_rng([1234, TRAIN_B, d, c]),
                                TRAIN_B, d, c, tie=False, dyadic=False)
        row = out[[r["name"] for r in out].index("qail_update")]
        row.update({
            "n_miss": qail_update.qail_update(tq, h, tam_t, owners, ty,
                                              tmask, lr=lr)[1].item(),
            "n_miss_random_targets":
                qail_update.qail_update(*rq[:-1], lr=rq[-1])[1].item(),
            "ms_random_targets": time_device_ms(
                lambda: qail_update.qail_update(*rq[:-1], lr=rq[-1])),
            "plain_ms_random_targets": time_device_ms(
                lambda: ref.qail_update_delta(*rq), samples=21, calls=2),
            "ms_random_targets_by_block_b": {
                bb: time_device_ms(lambda: qail_update.qail_update(
                    *rq[:-1], lr=rq[-1], block_b=bb))
                for bb in qail_update.BLOCK_B_CHOICES}})
        log({"phase": "rates", "sms": sms, "max_sm_clock_mhz": clk_mhz,
             "popc_per_s": popc_rate,
             "packed_search_popc_bound_ms": b * c * -(-dp // 4)
                                            / popc_rate * 1e3,
             "int8_ops_per_s": INT8_OPS_PER_S,
             "fp32_flop_per_s": FP32_FLOP_PER_S,
             "fp32_flop_per_s_from_clock": sms * 128 * 2 * clk_mhz * 1e6,
             "hbm_bytes_per_s": HBM_BYTES_PER_S,
             "shapes": {"B": b, "f": f, "D": d, "C": c,
                        "B_train": TRAIN_B}})
        log({"kernels": out})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of build,kernels,main,train,cli,"
                         "trainer,repro (development runs; train needs "
                         "main, the kernels line needs kernels, main and "
                         "train)")
    args = ap.parse_args()
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository: src/repro_torch not found")
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: chip_smoke.py needs one GPU")
    gpu = nvidia_smi("name,power.limit")
    kind = torch.cuda.get_device_name(0)
    log(gpu)
    log({"phase": "device", "torch": torch.__version__,
         "cuda": torch.version.cuda, "kind": kind,
         "count": torch.cuda.device_count()})
    phases = (["build", "kernels", "main", "train", "cli", "trainer",
               "repro"]
              if args.phases == "all" else args.phases.split(","))
    smoke = Smoke()
    t0 = time.perf_counter()
    smoke.build()
    if "kernels" in phases:
        smoke.check_kernels()
    if "main" in phases:
        smoke.main_path()
    if "train" in phases:
        smoke.train_path()
        smoke.train_dyadic()
    if "cli" in phases:
        smoke.cli()
    if "trainer" in phases:
        smoke.trainer()
    if "repro" in phases:
        smoke.reproducibility()
    if all(p in phases for p in ("kernels", "main", "train")):
        smoke.kernel_line()
    log({"phase": "done", "seconds": round(time.perf_counter() - t0, 3)})
    log(gpu)
    if args.phases != "all":
        log({"partial_run": phases})  # a development run proves nothing
        return
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
