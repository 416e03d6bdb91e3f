"""Launch-configuration autotuner for the port's MEMHD hot-path kernels.

Port of ``repro.kernels.autotune``. The reference searches the Pallas
kernels' batch tile (``block_b``) under a VMEM budget; on the H100 the
search runs over the launch configurations the port's CUDA kernels
already have, and compiles nothing new:

* ``am_search_packed``: ``block_b`` in ``BLOCK_B_CHOICES`` (4, 8, 16,
  32). Candidates with the same launch plan are timed once (4, 8 and 16
  all launch 16-row query tiles), the counterpart of the reference's skip
  of candidates that clamp to the same tile.
* ``qail_update``: the sims pass's query tile, 16, 32 or 64.
* ``encode_pack``: the four block tiles of the fp32 mainloop
  (``binary_mvm.SGEMM_TILES``, through ``encode_pack_tiled``); the entry
  records the tile index, and its ``block_b`` is that tile's rows.
* ``am_search_multibit`` (64 rows), ``am_shortlist`` (16) and
  ``am_search_sparse`` (1 query a block) run one configuration each:
  their entry holds that one candidate, parity-checked and timed, and no
  dispatch reads it.

For each kernel and geometry the tuner builds inputs from a numpy seed
at each batch the port's paths dispatch that kernel at
(``KernelSpec.batches``; the geometry key has no batch). The serving
kernels run at ``SERVE_BATCHES``: a served request of about 32 rows,
the online engine's buckets up to 256, the 512-row half of a batch on two
shards and the served 1024-row batch. ``qail_update`` runs at
``QAIL_BATCHES``: the 256-row QAIL minibatch and its shards on two and
four devices. It skips every candidate whose block needs more shared
memory than the device lets a block opt into (recorded in
``skipped_smem``), checks every other candidate bit for bit against
``kernels.ref`` on the same inputs BEFORE timing it (a configuration only
re-tiles the batch axis, so a difference is a bug and raises), then times
it at every batch. The winner flips with the batch (``encode_pack``'s
tile 1 at f = 784, D = 1024 ran 1.33x faster than the default at 512
rows and 1.28x slower at 1024 on an H100 80GB HBM3 at 700 W; PERF.md
§6), so an entry names
another configuration than the default only where one beats the default
at every tuned batch, and ``ops`` reads it only for a batch inside the
tuned range. On a CUDA device the time is the device time from CUDA
events (``time_device_ms``); on the CPU the kernels' plain versions
ignore the configuration, so a CPU run only checks parity, times the
wall clock and writes an entry keyed ``cpu`` whose times say nothing.

The winner is cached per (kernel, device name, geometry) in a JSON file,
``autotune_cache.json`` beside this module, or ``$MEMHD_TORCH_AUTOTUNE_
CACHE`` (not the reference's variable: a process that imports both
packages would share it, and the reference's tiles, 64-1024, are ones
the port's kernels cannot run). The device name is
``torch.cuda.get_device_name``; an entry also carries the card's power
limit and SM count, the winning launch plan and the skipped candidates.
``ops`` resolves ``block_b=None`` on a CUDA tensor to the cached winner
for that device and geometry when the batch lies in the entry's
``tuned_batches`` range, for ``am_search_packed`` (popcount mode only,
the mode the tuner times), ``qail_update`` and ``encode_pack``, else to
the kernel's default; it memoises the
entry's tile per (kernel, device, geometry) in ``RESOLVED``, which
``save_entry`` clears (set ``$MEMHD_TORCH_AUTOTUNE_CACHE`` before the
first dispatch). Re-tune after changing a kernel with:

    PYTHONPATH=src python -m repro_torch.kernels.autotune --kernel all

on the GPU (``--device cpu`` for the plain-version dry run).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import am_search_multibit as _amb
from repro_torch.kernels import am_search_packed as _asp
from repro_torch.kernels import am_search_sparse as _ass
from repro_torch.kernels import am_shortlist as _shl
from repro_torch.kernels import binary_mvm as _bm
from repro_torch.kernels import encode_fused as _ef
from repro_torch.kernels import qail_update as _qu
from repro_torch.kernels import ref

SCHEMA_VERSION = 1
CACHE_ENV = "MEMHD_TORCH_AUTOTUNE_CACHE"
DEFAULT_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "autotune_cache.json")
TILE = 128
# The dynamic shared memory an sm_90 block may opt into (227 KiB), and an
# H100 SXM's SM count: the budget and the plans of a CPU run, which has
# no device to ask.
SM90_SMEM_OPTIN = 232448
HOPPER_SMS = 132
# The qail_update candidates run at this dyadic lr on ±1 payloads: every
# Eq.-(6) term is ±2^-4, so every tile's sums are exact and order-free.
QAIL_LR = 0.0625
# The batches the paths dispatch (see the module docstring).
SERVE_BATCHES = (32, 256, 512, 1024)
QAIL_BATCHES = (64, 128, 256)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One tunable kernel: geometry key dims, candidates, runners.

    A candidate is a ``block_b`` (``encode_pack``: a tile index of
    ``binary_mvm.SGEMM_TILES``, whose rows are its ``block_b``)."""

    name: str
    key_dims: Tuple[str, ...]          # geometry dims identifying a config
    default_block_b: int
    candidates: Tuple[int, ...]
    make_inputs: Callable             # (rng, batch, dims, device) -> args
    run: Callable                     # (candidate, *args) -> outputs
    run_ref: Callable                 # (*args) -> plain outputs
    plan: Callable                    # (candidate, batch, dims, sms) -> dict
    default: Optional[int] = None     # default candidate (None: the block_b)
    block_b_of: Callable = int        # candidate -> the entry's block_b
    batches: Tuple[int, ...] = SERVE_BATCHES  # rows the candidates run at

    @property
    def default_candidate(self) -> int:
        return self.default_block_b if self.default is None else self.default


def _bipolar(rng, shape, device) -> torch.Tensor:
    return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape)
                           .astype(np.float32), device=device)


def _asp_inputs(rng, batch, dims, device):
    d = dims["D"]
    q = _bipolar(rng, (batch, d), device)
    am = _bipolar(rng, (dims["C"], d), device)
    return ref.pack_rows(q), ref.pack_rows(am).T.contiguous(), d


def _asp_plan(bb, batch, dims, sms):
    return _asp.launch_plan(batch, -(-dims["D"] // 8), dims["C"], bb,
                            "popcount", sms)


def _ef_inputs(rng, batch, dims, device):
    # Features on a 2^-8 grid: every product and partial sum is exact, so
    # each tile's sign bits equal the plain product's in any order.
    x = rng.random((batch, dims["f"])).astype(np.float32)
    feats = torch.as_tensor(np.round(x * 256) / 256, device=device)
    return feats, _bipolar(rng, (dims["f"], dims["D"]), device)


def _ef_plan(tile, batch, dims, sms):
    del sms
    return {"tile": tile, "bm_bn_tm_threads_bk": list(_bm.SGEMM_TILES[tile]),
            "grid": list(_bm.sgemm_grid(batch, dims["D"], tile)),
            "smem": _bm.sgemm_smem(tile)}


def _qu_inputs(rng, batch, dims, device):
    d, c = dims["D"], dims["C"]
    classes = max(dims.get("classes", 10), 1)
    q = _bipolar(rng, (batch, d), device)
    upd = _bipolar(rng, (batch, d), device)
    am_t = _bipolar(rng, (d, c), device)
    own = torch.as_tensor(rng.integers(0, classes, size=(c,))
                          .astype(np.int32), device=device)
    labels = torch.as_tensor(rng.integers(0, classes, size=(batch,))
                             .astype(np.int32), device=device)
    mask = torch.ones((batch,), dtype=torch.float32, device=device)
    return q, upd, am_t, own, labels, mask


def _qu_plan(bb, batch, dims, sms):
    del sms
    return {"block_b": bb, **_qu.plan(batch, dims["D"], dims["C"], bb),
            "smem": _qu.sims_smem(bb)}


def _amb_kw(bits):
    return dict(cell_bits=bits, tile_rows=TILE, tile_cols=TILE, adc_bits=16,
                adc_clip=ref.multibit_adc_clip(bits, TILE))


def _amb_inputs(rng, batch, dims, device):
    # A quantized float AM in offset-code bit planes (the reference's
    # inline quantizer).
    d, c, bits = dims["D"], dims["C"], dims["bits"]
    qmax = 2 ** (bits - 1) - 1
    fp = rng.normal(size=(c, d)).astype(np.float32)
    scale = np.abs(fp).max() / qmax
    codes = np.clip(np.round(fp / scale), -qmax, qmax).astype(np.int32)
    planes = ref.pack_planes(torch.as_tensor(codes + qmax, device=device),
                             bits)
    return _bipolar(rng, (batch, d), device), planes, bits


def _amb_plan(bb, batch, dims, sms):
    del bb, sms
    return _amb.launch_plan(batch, dims["D"], dims["C"], TILE)


def _shl_inputs(rng, batch, dims, device):
    d = dims["D"]
    q = _bipolar(rng, (batch, d), device)
    am = _bipolar(rng, (dims["G"], d), device)
    return ref.pack_rows(q), ref.pack_rows(am).T.contiguous(), d, dims["S"]


def _shl_plan(bb, batch, dims, sms):
    del bb
    return _shl.launch_plan(batch, -(-dims["D"] // 8), dims["G"], dims["S"],
                            sms)


def _ass_inputs(rng, batch, dims, device):
    # The gathered-tiles scan: per-query tile slabs with unique original
    # ids and an invalid (id -1) run, shared across the batch.
    d, t = dims["D"], dims["T"]
    tc = t * TILE
    cols = _bipolar(rng, (tc, d), device)
    q = _bipolar(rng, (batch, d), device)
    ids = rng.permutation(4 * tc)[:tc].astype(np.int32)
    ids[tc - TILE // 2:] = -1
    qp = ref.pack_rows(q)
    tiles = ref.pack_rows(cols).T[None].expand(batch, qp.shape[1], tc)
    ids_b = torch.as_tensor(ids, device=device)[None].expand(batch, tc)
    return qp, tiles.contiguous(), ids_b.contiguous(), d, dims["K"]


def _ass_plan(bb, batch, dims, sms):
    del bb, sms
    return _ass.launch_plan(batch, -(-dims["D"] // 8), dims["T"] * TILE)


KERNELS: Dict[str, KernelSpec] = {
    "am_search_multibit": KernelSpec(
        name="am_search_multibit",
        key_dims=("D", "C", "bits"),
        default_block_b=_amb.BLOCK_ROWS,
        candidates=_amb.BLOCK_B_CHOICES,
        make_inputs=_amb_inputs,
        # One configuration: the candidate is the kernel's only tile.
        run=lambda bb, q, planes, bits: _amb.am_search_multibit(
            q, planes, None, **_amb_kw(bits)),
        run_ref=lambda q, planes, bits: ref.am_search_multibit(
            q, planes, **_amb_kw(bits)),
        plan=_amb_plan,
    ),
    "am_search_packed": KernelSpec(
        name="am_search_packed",
        key_dims=("D", "C"),
        default_block_b=_asp.DEFAULT_BLOCK_B,
        candidates=_asp.BLOCK_B_CHOICES,
        make_inputs=_asp_inputs,
        run=lambda bb, qp, apt, d: _asp.am_search_packed(
            qp, apt, n_dims=d, block_b=bb),
        run_ref=lambda qp, apt, d: ref.am_search_packed(qp, apt, d),
        plan=_asp_plan,
    ),
    "am_shortlist": KernelSpec(
        name="am_shortlist",
        key_dims=("D", "G", "S"),
        default_block_b=_shl.ROWS,
        candidates=_shl.BLOCK_B_CHOICES,
        make_inputs=_shl_inputs,
        run=lambda bb, qp, spt, d, s: _shl.am_shortlist(qp, spt, n_dims=d,
                                                       s=s),
        run_ref=lambda qp, spt, d, s: ref.am_shortlist(qp, spt, d, s),
        plan=_shl_plan,
    ),
    "am_search_sparse": KernelSpec(
        name="am_search_sparse",
        key_dims=("D", "T", "K"),
        default_block_b=_ass.BLOCK_B_CHOICES[0],
        candidates=_ass.BLOCK_B_CHOICES,
        make_inputs=_ass_inputs,
        run=lambda bb, qp, tiles, ids, d, k: (
            _ass.am_search_sparse_gathered(qp, tiles, ids, n_dims=d, k=k)),
        run_ref=lambda qp, tiles, ids, d, k: ref.am_search_sparse(
            qp, tiles, ids, d, k),
        plan=_ass_plan,
    ),
    "encode_pack": KernelSpec(
        name="encode_pack",
        key_dims=("f", "D"),
        default_block_b=_bm.SGEMM_TILES[_bm.SGEMM_TILE][0],
        candidates=tuple(range(len(_bm.SGEMM_TILES))),
        make_inputs=_ef_inputs,
        run=lambda tile, feats, proj: _ef.encode_pack_tiled(feats, proj,
                                                            tile),
        run_ref=lambda feats, proj: ref.encode_pack(feats, proj),
        plan=_ef_plan,
        default=_bm.SGEMM_TILE,
        block_b_of=lambda tile: _bm.SGEMM_TILES[tile][0],
    ),
    "qail_update": KernelSpec(
        name="qail_update",
        key_dims=("D", "C"),
        default_block_b=_qu.DEFAULT_BLOCK_B,
        candidates=_qu.BLOCK_B_CHOICES,
        make_inputs=_qu_inputs,
        run=lambda bb, q, upd, am_t, own, y, m: _qu.qail_update(
            q, upd, am_t, own, y, m, lr=QAIL_LR, block_b=bb),
        run_ref=lambda q, upd, am_t, own, y, m: ref.qail_update_delta(
            q, upd, am_t, own, y, m, QAIL_LR),
        plan=_qu_plan,
        batches=QAIL_BATCHES,
    ),
}

# The reference's paper geometries, then those the port's paths run at
# full width (f = 784, D = C = 1024; the hierarchical artifact of the
# main model, G = 45, and the huge-label point, G = 448).
DEFAULT_GEOMETRIES: Dict[str, Tuple[Dict[str, int], ...]] = {
    "am_search_multibit": ({"D": 128, "C": 128, "bits": 2},
                           {"D": 128, "C": 128, "bits": 4},
                           {"D": 1024, "C": 1024, "bits": 4}),
    "am_search_packed": ({"D": 128, "C": 128}, {"D": 256, "C": 256},
                         {"D": 1024, "C": 1024}),
    "am_shortlist": ({"D": 128, "G": 16, "S": 8},
                     {"D": 1024, "G": 448, "S": 8},
                     {"D": 1024, "G": 45, "S": 45}),
    "am_search_sparse": ({"D": 128, "T": 8, "K": 1},
                         {"D": 1024, "T": 16, "K": 1},
                         {"D": 1024, "T": 16, "K": 5}),
    "encode_pack": ({"f": 784, "D": 128}, {"f": 617, "D": 512},
                    {"f": 784, "D": 1024}),
    "qail_update": ({"D": 128, "C": 128}, {"D": 256, "C": 64},
                    {"D": 1024, "C": 1024}),
}


def geometry_key(kernel: str, **dims) -> str:
    """Canonical geometry key, batch-agnostic (the reference's)."""
    spec = KERNELS[kernel]
    missing = [k for k in spec.key_dims if k not in dims]
    if missing:
        raise KeyError(f"{kernel} geometry needs dims {spec.key_dims}, "
                       f"missing {missing}")
    return "_".join(f"{k}{int(dims[k])}" for k in spec.key_dims)


def cache_path() -> str:
    return os.environ.get(CACHE_ENV) or DEFAULT_CACHE


_LOAD_MEMO: Dict[str, Dict] = {}
_NAMES: Dict[int, str] = {}
# ops' memo of the tile a dispatch resolves: (kernel, device index, dims)
# -> (block_b, tile, least and most tuned batch) or None, from the cache
# at cache_path() when the geometry was first dispatched.
RESOLVED: Dict[tuple, Optional[tuple]] = {}


def device_name(device=None) -> str:
    """The cache's device key: ``torch.cuda.get_device_name`` of a CUDA
    device, ``cpu`` otherwise (None: the current CUDA device if there is
    one, else the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            return "cpu"
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _NAMES:
        _NAMES[index] = torch.cuda.get_device_name(index)
    return _NAMES[index]


def load_cache(path: Optional[str] = None) -> Dict[str, Dict]:
    """The cache's entries dict, read once per path for the life of the
    process (``save_entry`` refreshes it), so a dispatch reads no file."""
    path = os.path.abspath(path or cache_path())
    if path not in _LOAD_MEMO:
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            data = {}
        entries = data.get("entries", {})
        if data.get("schema_version") != SCHEMA_VERSION:
            entries = {}
        _LOAD_MEMO[path] = entries
    return _LOAD_MEMO[path]


def save_entry(entry: Dict, path: Optional[str] = None) -> str:
    path = os.path.abspath(path or cache_path())
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        data = {}
    if data.get("schema_version") != SCHEMA_VERSION:
        data = {"schema_version": SCHEMA_VERSION, "entries": {}}
    key = f"{entry['kernel']}|{entry['device']}|{entry['geometry']}"
    data["entries"][key] = entry
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
        f.write("\n")
    _LOAD_MEMO[path] = data["entries"]
    RESOLVED.clear()
    return path


def lookup(kernel: str, geometry: str, device: Optional[str] = None,
           ) -> Optional[Dict]:
    """The cached entry of ``kernel`` at ``geometry`` on the device named
    ``device`` (default: ``device_name()``), or None."""
    device = device or device_name()
    return load_cache().get(f"{kernel}|{device}|{geometry}")


def tuned_block_b(kernel: str, **dims) -> int:
    """The cached winner's block_b on the current device, else the
    kernel's default."""
    entry = lookup(kernel, geometry_key(kernel, **dims))
    if entry is not None:
        return int(entry["block_b"])
    return KERNELS[kernel].default_block_b


def time_device_ms(fn, samples: int = 21, calls: int = 10) -> float:
    """Median device time of one call, in ms, from CUDA events.

    Each sample parks the stream behind ``torch.cuda._sleep`` while the
    host enqueues ``calls`` calls, so the events bracket back-to-back
    device work: the sleep lasts four times the host's enqueue of
    ``calls`` calls (at least ~1 ms), or a fast kernel behind a heavy
    wrapper would be timed at the host's pace."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # _sleep counts SM clock cycles: 2e9 a second is above the H100's top
    # clock, so the sleep lasts at least as long as asked.
    cycles = min(max(2_000_000, int(4 * enqueue_s * 2e9)), 400_000_000)
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _time_wall_ms(fn, iters: int = 3) -> float:
    """Least wall time of one call (the plain versions on the CPU)."""
    fn()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def _flat(out) -> tuple:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _assert_parity(got, want, label: str) -> None:
    got, want = _flat(got), _flat(want)
    if len(got) != len(want):
        raise RuntimeError(f"{label}: {len(got)} outputs, plain {len(want)}")
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            raise RuntimeError(label)


def _power_limit_w(index: int) -> Optional[float]:
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def _smem_limit(device: torch.device) -> int:
    """The dynamic shared memory a block may opt into on ``device``."""
    if device.type != "cuda":
        return SM90_SMEM_OPTIN
    props = torch.cuda.get_device_properties(device)
    limit = getattr(props, "shared_memory_per_block_optin", None)
    if limit:
        return int(limit)
    if props.major == 9:
        return SM90_SMEM_OPTIN
    raise RuntimeError(f"no shared-memory limit known for {props.name}")


def _pick(timings: Dict[str, Dict[int, float]], default: Optional[str],
          batches) -> str:
    """The winner among the timed candidates: the default's, unless
    another beats it at every batch (then the one with the least mean
    time relative to the default); with no default timed, the least mean
    time."""
    def rel(c):
        base = timings[default] if default is not None else None
        return statistics.fmean(
            timings[c][b] / (base[b] if base else 1.0) for b in batches)
    if default is None:
        return min(timings, key=rel)
    beat = [c for c in timings if c != default and all(
        timings[c][b] < timings[default][b] for b in batches)]
    return min(beat, key=rel) if beat else default


def _us(ms: Dict[int, float]) -> Dict[str, float]:
    return {str(b): round(v * 1e3, 3) for b, v in ms.items()}


def autotune_kernel(kernel: str, dims: Dict[str, int], *,
                    batches: Optional[Tuple[int, ...]] = None,
                    iters: int = 3, seed: int = 0,
                    device=None, save: bool = True,
                    cache: Optional[str] = None,
                    smem_limit: Optional[int] = None) -> Dict:
    """Tune one kernel at one geometry; returns (and caches) the entry.

    ``batches``: the rows the candidates are timed at (default: the
    spec's, the batches its paths dispatch). ``device``: where the
    candidates run (default: the GPU). Every candidate within the
    shared-memory limit (default: the device's opt-in limit a block) at
    every batch is checked bit for bit against the plain version before
    it is timed; candidates with the same launch plans are timed once
    (``same_plan`` maps each skipped one to the one timed). The entry
    names another configuration than the default only where one is
    faster at every batch.
    """
    from repro_torch import resolve_device
    spec = KERNELS[kernel]
    batches = tuple(spec.batches if batches is None else batches)
    device = resolve_device(device)
    on_gpu = device.type == "cuda"
    rng = np.random.default_rng(seed)
    inputs = {b: spec.make_inputs(rng, b, dims, device) for b in batches}
    want = {b: spec.run_ref(*args) for b, args in inputs.items()}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if on_gpu else HOPPER_SMS)
    limit = _smem_limit(device) if smem_limit is None else smem_limit

    timings: Dict[str, Dict[int, float]] = {}
    plans: Dict[str, Dict[int, Dict]] = {}
    skipped: Dict[str, int] = {}
    same_plan: Dict[str, str] = {}
    seen: Dict[str, str] = {}
    for cand in spec.candidates:
        plan = {b: spec.plan(cand, b, dims, sms) for b in batches}
        smem = max(p["smem"] for p in plan.values())
        if smem > limit:
            skipped[str(cand)] = int(smem)
            continue
        plan_key = json.dumps(list(plan.values()), sort_keys=True)
        if plan_key in seen:
            same_plan[str(cand)] = seen[plan_key]
            continue
        seen[plan_key] = str(cand)
        timings[str(cand)] = {}
        for b, args in inputs.items():
            _assert_parity(spec.run(cand, *args), want[b],
                           f"{kernel} candidate {cand} at {dims}, B = {b}, "
                           f"diverged from the plain version")
            run = lambda: spec.run(cand, *args)  # noqa: E731
            timings[str(cand)][b] = (time_device_ms(run) if on_gpu
                                     else _time_wall_ms(run, iters))
        plans[str(cand)] = plan
    if not timings:
        raise RuntimeError(f"{kernel}: every candidate in {spec.candidates} "
                           f"needs more than {limit} bytes of shared memory")
    default = str(spec.default_candidate)
    default_key = same_plan.get(default, default)
    if default_key not in timings:
        default_key = None
    won = _pick(timings, default_key, batches)
    best = spec.default_candidate if won == default_key else int(won)
    best_ms = timings[won]
    default_ms = timings[default_key] if default_key is not None else None
    entry = {
        "kernel": kernel,
        "device": device_name(device),
        "geometry": geometry_key(kernel, **dims),
        "dims": {k: int(v) for k, v in dims.items()},
        "block_b": int(spec.block_b_of(best)),
        "default_block_b": spec.default_block_b,
        "tuned_batches": [int(b) for b in batches],
        "best_us": _us(best_ms),
        "default_us": _us(default_ms) if default_ms is not None else None,
        "speedup_vs_default": (
            {str(b): round(default_ms[b] / best_ms[b], 3) for b in batches}
            if default_ms is not None else None),
        "candidates_us": {k: _us(v) for k, v in timings.items()},
        "same_plan": same_plan,
        "skipped_smem": skipped,
        "smem_limit_bytes": int(limit),
        "smem_bytes": int(max(p["smem"] for p in plans[won].values())),
        "plan": {str(b): p for b, p in plans[won].items()},
        "sms": sms if on_gpu else None,
        "power_limit_w": (_power_limit_w(device.index or 0) if on_gpu
                          else None),
        "timing": ("cuda events, median of 21 samples" if on_gpu
                   else "cpu wall clock (plain versions; not a "
                        "device time)"),
        "created_unix": int(time.time()),
    }
    if kernel == "encode_pack":
        entry["tile"] = int(best)
        entry["default_tile"] = int(spec.default_candidate)
    if save:
        save_entry(entry, path=cache)
    return entry


def autotune_all(kernels=None, *,
                 batches: Optional[Tuple[int, ...]] = None, iters: int = 3,
                 device=None, cache: Optional[str] = None,
                 verbose: bool = True):
    entries = []
    for kernel in kernels or KERNELS:
        for dims in DEFAULT_GEOMETRIES[kernel]:
            entry = autotune_kernel(kernel, dims, batches=batches,
                                    iters=iters, device=device, cache=cache)
            entries.append(entry)
            if verbose:
                print(f"autotune: {kernel} {entry['geometry']} on "
                      f"{entry['device']} at B {entry['tuned_batches']} -> "
                      f"{entry.get('tile', entry['block_b'])} "
                      f"({entry['best_us']} us; default "
                      f"{entry.get('default_tile', entry['default_block_b'])}"
                      f" {entry['default_us']} us)", flush=True)
    return entries


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="all",
                    choices=["all"] + sorted(KERNELS),
                    help="which kernel to tune")
    ap.add_argument("--batches", default=None,
                    help="comma-separated query batches the candidates "
                         "are timed at (default: each kernel's path "
                         "batches, KernelSpec.batches)")
    ap.add_argument("--iters", type=int, default=3,
                    help="wall-clock repeats of a CPU run")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default {DEFAULT_CACHE}, or "
                         f"${CACHE_ENV})")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain versions")
    args = ap.parse_args(argv)
    kernels = list(KERNELS) if args.kernel == "all" else [args.kernel]
    batches = (None if args.batches is None
               else tuple(int(b) for b in args.batches.split(",")))
    autotune_all(kernels, batches=batches, iters=args.iters,
                 device=args.device, cache=args.cache)
    print(f"autotune: cache -> {args.cache or cache_path()}")


if __name__ == "__main__":
    main()
