"""Serving records: one ``BENCH_<name>.json`` per serving run.

Port of what the serving CLIs' ``--record-dir`` needs of the reference's
``benchmarks/record.py``: ``Recorder`` (``emit``, ``record``, ``path``,
``write``) and ``from_report``, which wraps a flat JSON report (the
serving report of ``launch/serve_memhd.py`` or ``launch/serve_online.py``)
into a schema-versioned record in ``out_dir``. The bench harness's parts
(the process-wide active recorder, per-row timing statistics, the default
results and baselines directories) are not here: ``out_dir`` is required.

Schema (v1), the reference's with its two JAX keys (``jax_backend``,
``jax_version``) replaced by ``torch_version`` and ``device``:

    {
      "schema_version": 1,
      "bench": "<name>",               # BENCH_<name>.json
      "created_unix": 1733...,
      "git_sha": "abc1234" | null,
      "torch_version": "2.5...",
      "device": {"platform": "gpu" | "cpu", "name": ...,
                 "power_limit_w": 700.0 | null, "count": 1},
      "meta": {...,                    # the report's non-numeric fields
               "obs": {"compiles_total": ..., "dispatch_tiers": {...}}},
      "metrics": {"<field>": {"us_per_call": ..., "derived": "...",
                              "value": ...}, ...}
    }

On a CUDA device ``name`` is ``torch.cuda.get_device_name`` and
``power_limit_w`` comes from ``nvidia-smi`` (``torchmon.power_limit_w``,
which raises where it fails: a record made on a card never leaves the
card's limit out). On the CPU ``name`` is ``"cpu"``, ``power_limit_w``
null and ``count`` 1.

``meta["obs"]`` is computed as the reference computes it:
``compiles_total`` is ``torchmon.rebuilds()`` (the port's kernel builds
and graph captures, the counter behind the serving report's
``metrics.compiles_total``) and ``dispatch_tiers`` the per-kernel tier
counts (``cuda`` / ``torch-ref``) added since the ``Recorder`` was made.
``from_report`` makes its ``Recorder`` after the run, so there that delta
is empty, as the reference's is; the whole run's tiers reach the record
through the report's own ``metrics.dispatch_tiers``, in ``meta``.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.obs import torchmon

SCHEMA_VERSION = 1
RECORD_PREFIX = "BENCH_"

TOP_LEVEL_KEYS = frozenset({
    "schema_version", "bench", "created_unix", "git_sha",
    "torch_version", "device", "meta", "metrics",
})
METRIC_REQUIRED_KEYS = frozenset({"us_per_call", "derived"})

_REPO_ROOT = Path(__file__).resolve().parents[3]


def _dispatch_breakdown() -> Dict[str, Dict[str, int]]:
    from repro_torch.kernels import ops
    return ops.dispatch_breakdown()


def _obs_meta(baseline: Dict[str, Dict[str, int]]) -> Dict:
    """``meta["obs"]``: the rebuild count and the dispatch-tier counts
    added over ``baseline``."""
    tiers: Dict[str, Dict[str, int]] = {}
    for kernel, by_tier in _dispatch_breakdown().items():
        for tier, n in by_tier.items():
            delta = n - baseline.get(kernel, {}).get(tier, 0)
            if delta > 0:
                tiers.setdefault(kernel, {})[tier] = delta
    return {"compiles_total": torchmon.rebuilds(), "dispatch_tiers": tiers}


def git_sha() -> Optional[str]:
    """The checkout's short commit, or None outside a checkout."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=_REPO_ROOT,
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or None
    except OSError:
        return None


def device_fields(device=None) -> Dict:
    """The record's ``device``: ``device`` (default the GPU when there is
    one, else the CPU) as platform, name, power limit and device count."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cpu":
        return {"platform": "cpu", "name": "cpu", "power_limit_w": None,
                "count": 1}
    if device.type != "cuda":
        raise ValueError(f"no record fields for device {device}")
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return {"platform": "gpu", "name": torch.cuda.get_device_name(index),
            "power_limit_w": torchmon.power_limit_w(index),
            "count": torch.cuda.device_count()}


class Recorder:
    """Accumulates one run's structured metrics into a record."""

    def __init__(self, bench: str, out_dir: str, meta: Optional[Dict] = None,
                 device=None):
        self.bench = bench
        self.out_dir = out_dir
        self.meta: Dict = dict(meta or {})
        self.metrics: Dict[str, Dict] = {}
        self.device = device
        # Count rebuilds from here on and remember the dispatch counters'
        # state, so that record() attributes this run's delta.
        torchmon.install()
        self._obs_baseline = _dispatch_breakdown()

    def emit(self, name: str, us_per_call: float, derived,
             **extra) -> None:
        metric: Dict[str, object] = {
            "us_per_call": float(us_per_call),
            "derived": str(derived),
        }
        metric.update(extra)
        self.metrics[name] = metric

    def record(self) -> Dict:
        meta = dict(self.meta)
        meta["obs"] = _obs_meta(self._obs_baseline)
        return {
            "schema_version": SCHEMA_VERSION,
            "bench": self.bench,
            "created_unix": int(time.time()),
            "git_sha": git_sha(),
            "torch_version": torch.__version__,
            "device": device_fields(self.device),
            "meta": meta,
            "metrics": self.metrics,
        }

    @property
    def path(self) -> str:
        return os.path.join(self.out_dir,
                            f"{RECORD_PREFIX}{self.bench}.json")

    def write(self) -> str:
        rec = self.record()  # before the file: a failure leaves none
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
        return self.path


def from_report(bench: str, report: Dict, out_dir: str,
                device=None) -> str:
    """Wrap a flat JSON report into a ``BENCH_<bench>.json`` record in
    ``out_dir``; returns its path.

    Numeric scalar fields become metrics (``value`` carries the number;
    ``lat_ms_*`` fields also fill ``us_per_call``, in microseconds, else
    it is 0.0); everything else lands in ``meta``. ``device`` is the one
    the report was served on (default as ``device_fields``).
    """
    rec = Recorder(bench, out_dir, device=device)
    for key, val in report.items():
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            rec.meta[key] = val
            continue
        us = float(val) * 1e3 if key.startswith("lat_ms") else 0.0
        rec.emit(key, us, val, value=float(val))
    return rec.write()
