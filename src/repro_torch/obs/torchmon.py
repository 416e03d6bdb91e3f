"""PyTorch/CUDA runtime introspection -> the obs metrics registry.

The port's counterpart of ``repro.obs.jaxmon``. JAX compiles an
executable per new shape, so the reference counts XLA compiles; the port
has no tracer and no jit cache. What it builds at run time instead is
its CUDA kernel library (``kernels/_build.build``, nvcc) and, once CUDA
graphs exist (ROADMAP 2c), graph captures. Those are what a serving
loop that is not in steady state would pay for:

  * ``kernel_builds_total`` — nvcc builds of the kernel library that
    really ran (a cache hit on an existing library is not counted);
  * ``cuda_graph_captures_total`` — CUDA graph captures (nothing
    captures yet, so it stays 0);
  * ``rebuilds()`` — their sum: the port's reading of the reference's
    compile count, behind the serving report's
    ``recompiles_steady_state``;
  * ``update_memory_gauges()`` — ``torch.cuda.memory_stats()`` per CUDA
    device into ``torch_device_memory_bytes{device=..., stat=...}``; the
    CPU has no allocator stats and is skipped, not faked;
  * ``assert_no_rebuilds()`` — raises ``SteadyStateError`` when a region
    that must be in steady state built or captured anything;
  * ``power_limit_w(index)`` — the card's power limit from
    ``nvidia-smi`` (the autotuner's cache entries and the serving
    record carry it beside their times); it raises where ``nvidia-smi``
    fails.

``install()`` registers the counters (idempotent); everything here is
safe to import without a GPU.
"""
from __future__ import annotations

import subprocess
import threading
from contextlib import contextmanager
from typing import Dict

from repro_torch.obs import metrics as _metrics

BUILDS = "kernel_builds_total"
CAPTURES = "cuda_graph_captures_total"

_install_lock = threading.Lock()
_installed = False


class SteadyStateError(AssertionError):
    """A region that must be in steady state built or captured anyway."""


def install() -> None:
    """Register the build and capture counters (once per process)."""
    global _installed
    with _install_lock:
        if _installed:
            return
        _metrics.counter(BUILDS, "nvcc builds of the CUDA kernel library "
                                 "(a cached library is not counted)")
        _metrics.counter(CAPTURES, "CUDA graph captures")
        _installed = True


def installed() -> bool:
    return _installed


def count_build() -> None:
    """One nvcc build of the kernel library (``kernels/_build.build``)."""
    install()
    _metrics.counter(BUILDS).inc()


def rebuilds() -> int:
    """Kernel builds + graph captures counted so far."""
    total = 0
    for name in (BUILDS, CAPTURES):
        fam = _metrics.REGISTRY.get(name)
        if fam is not None:
            total += int(fam.total())
    return total


@contextmanager
def count_rebuilds():
    """Yields a zero-arg callable returning the rebuild delta so far."""
    install()
    before = rebuilds()
    yield lambda: rebuilds() - before


@contextmanager
def assert_no_rebuilds(what: str = "steady-state region"):
    """Raise ``SteadyStateError`` if a kernel build or graph capture happens
    inside: wrap the post-warmup body of a serving loop."""
    install()
    before = rebuilds()
    yield
    delta = rebuilds() - before
    if delta:
        raise SteadyStateError(
            f"{what}: {delta} kernel build(s) or graph capture(s) in a "
            f"region that must be in steady state ({BUILDS} + {CAPTURES} "
            f"{before} -> {before + delta})")


def update_memory_gauges() -> Dict[str, Dict[str, float]]:
    """Per-CUDA-device ``torch.cuda.memory_stats()`` -> gauges; returns
    what it set. Without a CUDA device it sets nothing."""
    import torch

    gauge = _metrics.gauge(
        "torch_device_memory_bytes",
        "per-device allocator stats from torch.cuda.memory_stats()")
    out: Dict[str, Dict[str, float]] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if not stats:
            continue
        label = f"cuda:{i}"
        kept = {k: float(v) for k, v in stats.items()
                if isinstance(v, (int, float))}
        for stat, val in kept.items():
            gauge.set(val, device=label, stat=stat)
        out[label] = kept
    return out


def power_limit_w(index: int) -> float:
    """The power limit of GPU ``index`` in watts, as ``nvidia-smi`` reads
    it; raises when ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])
