#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed on its own line(s); any failure raises and the
script exits non-zero without the final result line:

0. the card: ``nvidia-smi`` name and power limit, torch's device name;
1. the build: nvcc compiles the three kernels of ``src/repro_torch/
   kernels/csrc`` for sm_90a (timed, with ptxas' register report);
2. each kernel against its plain PyTorch version on the card, over the
   differential geometry grid, tie and padding cases and the full-width
   shapes: ``pack_bits`` and ``am_search_packed`` bit-exact,
   ``encode_pack`` bit-exact on dyadic features and within the stated
   tolerance on float features;
3. the main path at the paper's widest MNIST point (f = 784, D = C =
   1024, R = 0.8, lr = 0.02, batch 256, 25 k-means iterations) on the
   full synthetic MNIST: ``MemhdModel.create`` -> ``fit`` ->
   ``deploy(target="packed")`` -> ``serve_batches`` staged and fused at
   depth 2; kernel launch counts are zeroed just before and read just
   after, and staged == fused == the plain ``MemhdModel.predict`` bit for
   bit on dyadic-rounded test features;
4. the serving CLI, staged and ``--fused``;
5. reproducibility: two 128 x 128 fits from the same seeds agree;
6. the ``kernels`` line: launches on the main path, device time, the
   plain version's time and the bound of each kernel at the main path's
   shapes.

The last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
# the fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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
EPOCHS = 100  # the paper's QAIL epochs: the main path runs them uncut


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
                        "encode_pack": 0.0}

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
                         int(diff.sum().item())})
        log({"phase": "kernels_vs_plain", "ok": True, "grid": rows,
             "max_abs_err_full_width": self.max_err})

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

        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
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

    def profile_serving(self, deployed, reqs, fused):
        """Device-busy share and the kernels that take the device time of
        one served stream (torch.profiler, CUDA activity)."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.launch import serve_memhd as sm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sm.serve_batches(deployed, reqs, max_batch=1024, warmup=False,
                             fused=fused, depth=2)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        from torch.autograd import DeviceType
        # Device-side events only (kernels, memcpys): the CPU op that
        # launched a kernel also reports its device time.
        rows = [(ev.self_device_time_total, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_us = sum(r[0] for r in rows)
        log({"phase": "serve_profile",
             "pipeline": "fused" if fused else "staged",
             "wall_us_profiled": round(wall_us, 1),
             "device_busy_us": round(busy_us, 1),
             "device_busy_share": round(busy_us / wall_us, 4),
             "top_device_ops": [{"op": k[:80], "us": round(u, 1), "count": c}
                                for u, k, c in rows[:8]]})

    # -- phase 4 ---------------------------------------------------------------
    def cli(self):
        from repro_torch.launch import serve_memhd as sm
        base = ["--smoke", "--requests", "32", "--max-size", "24",
                "--max-batch", "128"]
        for extra in ([], ["--fused"]):
            rep = sm.main(base + extra)
            tiers = rep["metrics"]["dispatch_tiers"]
            check("torch-ref" not in json.dumps(tiers), tiers)
            log({"phase": "cli", "args": base + extra, "ok": True})

    # -- phase 5 ---------------------------------------------------------------
    def reproducibility(self):
        torch = self.torch
        from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
        from repro_torch.data import load_dataset
        ds = load_dataset("mnist", train_per_class=300, test_per_class=50,
                          device=self.dev)
        enc = EncoderConfig(kind="projection", features=784, dim=128)
        amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=5,
                          kmeans_iters=10)
        ams = []
        for _ in range(2):
            m = MemhdModel.create(3, enc, amc, device=self.dev)
            m, _ = m.fit(4, ds.train_x, ds.train_y)
            ams.append(m.am_state)
        same_bin = torch.equal(ams[0]["binary"], ams[1]["binary"])
        same_fp = torch.equal(ams[0]["fp"], ams[1]["fp"])
        check(same_bin and same_fp, (same_bin, same_fp))
        log({"phase": "reproducibility", "binary_equal": same_bin,
             "fp_equal": same_fp})

    # -- phase 6 ---------------------------------------------------------------
    def kernel_line(self):
        np, torch = self.np, self.torch
        from repro_torch.core import encoding
        from repro_torch.kernels import am_search_packed as asp
        from repro_torch.kernels import encode_fused, pack_bits, ref

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

        cases = [
            ("pack_bits", "src/repro_torch/kernels/csrc/pack_bits.cu",
             "src/repro/kernels/pack_bits.py:43",
             lambda: pack_bits.pack_bits(q), lambda: ref.pack_bits(q),
             bound(q.numel() * 4 + q.numel() // 8, q.numel(),
                   FP32_FLOP_PER_S)),
            ("am_search_packed",
             "src/repro_torch/kernels/csrc/am_search_packed.cu",
             "src/repro/kernels/am_search_packed.py:167",
             lambda: asp.am_search_packed(qp, am_t, n_dims=d),
             lambda: ref.am_search_packed(qp, am_t, d),
             bound(qp.numel() + am_t.numel() + 8 * b,
                   b * c * -(-dp // 4), popc_rate)),
            ("encode_pack", "src/repro_torch/kernels/csrc/encode_pack.cu",
             "src/repro/kernels/encode_fused.py:97",
             lambda: encode_fused.encode_pack(feats, proj),
             lambda: ref.encode_pack(feats, proj),
             bound(feats.numel() * 4 + proj.numel() * 4 + b * dp,
                   2 * b * f * d, FP32_FLOP_PER_S)),
        ]
        out = []
        for name, src, replaces, kern, plain, (bound_ms, bound_by) in cases:
            ms = time_device_ms(kern)
            plain_ms = time_device_ms(plain, samples=21, calls=2)
            out.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": self.launches[name],
                "max_abs_err": self.max_err[name], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
        log({"phase": "rates", "sms": sms, "max_sm_clock_mhz": clk_mhz,
             "popc_per_s": popc_rate, "fp32_flop_per_s": FP32_FLOP_PER_S,
             "fp32_flop_per_s_from_clock": sms * 128 * 2 * clk_mhz * 1e6,
             "hbm_bytes_per_s": HBM_BYTES_PER_S,
             "shapes": {"B": b, "f": f, "D": d, "C": c}})
        log({"kernels": out})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma list of build,kernels,main,cli,repro "
                         "(development runs; the kernels line needs main)")
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
    phases = (["build", "kernels", "main", "cli", "repro"]
              if args.phases == "all" else args.phases.split(","))
    smoke = Smoke()
    t0 = time.perf_counter()
    smoke.build()
    if "kernels" in phases:
        smoke.check_kernels()
    if "main" in phases:
        smoke.main_path()
    if "cli" in phases:
        smoke.cli()
    if "repro" in phases:
        smoke.reproducibility()
    if "main" in phases and "kernels" in phases:
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
