"""Public dispatch surface of the port's kernel package.

Port of the serving dispatches of ``repro.kernels.ops``. Each keeps the
reference's ``use_kernel`` switch: a CUDA tensor with ``use_kernel=True``
or ``None`` (the reference's "the kernel on the accelerator") is served
by the hand-written CUDA kernel (tier ``cuda``); a CPU tensor, or
``use_kernel=False``, by the plain PyTorch version (tier ``torch-ref``);
a meta tensor (the dry run, ``distributed.cost``) by the plain version,
which computes nothing there (tier ``meta``).
Every call adds one to the ``(kernel, tier, geometry)`` series of the
``kernel_dispatch_total`` counter of the metrics registry
(``obs.metrics``), as in the reference; ``dispatch_breakdown()`` sums it
over geometries for the serving report.

Every op with a query tile takes the reference's ``block_b: int | None
= None``. An explicit tile wins and must be one the kernel runs (the
module's ``BLOCK_B_CHOICES``, else a ``ValueError`` names those values:
the reference's tiles, 64-1024, are not mapped onto the port's).
``None`` on a CUDA tensor reads the autotune cache (``kernels.autotune``)
for the tensor's card and geometry where the tuner timed more than one
configuration (``am_search_packed`` in popcount mode, ``qail_update``,
``encode_pack``) and the batch lies within the entry's
``tuned_batches``; a cached tile the kernel cannot run raises a
``ValueError`` naming the cache file. Otherwise (no entry, a batch
outside the tuned range, unpack mode, which the tuner does not time, the
single-configuration kernels, or the CPU, where the plain tier has no
tile) it is the kernel's default. The entry's tile is memoised per
(kernel, device, geometry), so after a geometry's first dispatch a
dispatch reads no environment, file or key string: set
``MEMHD_TORCH_AUTOTUNE_CACHE`` before the first dispatch
(``autotune.save_entry`` clears the memo). ``encode_pack``'s tuned
entry names a block tile of the fp32 mainloop
(``binary_mvm.SGEMM_TILES``); an explicit ``block_b`` is its default
tile's rows. ``tuned_block_b`` answers with the reference's signature
and rule (explicit, cached, default) for any batch. The IMC cycle counts
(``search_cycles``, ``packed_search_cycles``, ``encode_pack_cycles``,
``mvm_cycles``, ``imc_search_cycles``, ``multibit_search_cycles``) are
the reference's, as pure integer functions of the shapes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import am_search_multibit as _asm_mod
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import am_search_packed as _asp_mod
from repro_torch.kernels import am_search_sparse as _ass_mod
from repro_torch.kernels import am_shortlist as _asl_mod
from repro_torch.kernels import encode_fused as _ef_mod
from repro_torch.kernels import ref
from repro_torch.kernels.am_search import am_search as _am_search
from repro_torch.kernels.am_search import (  # noqa: F401
    imc_cycles_for as search_cycles,
)
from repro_torch.kernels.am_search_imc import am_search_imc as _am_search_imc
from repro_torch.kernels.am_search_imc import (  # noqa: F401
    imc_cycles_for as imc_search_cycles,
)
from repro_torch.kernels.am_search_multibit import (
    am_search_multibit as _am_search_multibit,
)
from repro_torch.kernels.am_search_multibit import (  # noqa: F401
    imc_cycles_for as multibit_search_cycles,
)
from repro_torch.kernels.am_search_packed import (
    am_search_packed as _am_search_packed,
)
from repro_torch.kernels.am_search_packed import (  # noqa: F401
    imc_cycles_for as packed_search_cycles,
)
from repro_torch.kernels.am_search_packed import pack_rows as _pack_rows
from repro_torch.kernels.am_search_sparse import (
    am_search_sparse as _am_search_sparse,
)
from repro_torch.kernels.am_search_sparse import am_search_sparse_plain
from repro_torch.kernels.am_shortlist import am_shortlist as _am_shortlist
from repro_torch.kernels.encode_fused import (
    encode_pack_tiled as _encode_pack_tiled,
)
from repro_torch.kernels.encode_fused import (  # noqa: F401
    imc_cycles_for as encode_pack_cycles,
)
from repro_torch.kernels.encode_fused import (
    predict_from_features as _predict_from_features,
)
from repro_torch.kernels.encode_fused import (
    search_from_features as _search_from_features,
)
from repro_torch.kernels.binary_mvm import SGEMM_TILE, SGEMM_TILES
from repro_torch.kernels.binary_mvm import binary_mvm as _binary_mvm
from repro_torch.kernels.binary_mvm import (  # noqa: F401
    imc_cycles_for as mvm_cycles,
)
from repro_torch.kernels.flash_decode import flash_decode as _flash_decode
from repro_torch.kernels.pack_bits import pack_bits as _pack_bits
from repro_torch.kernels.pack_bits import unpack_bits as _unpack_bits
from repro_torch.kernels.qail_update import (
    BLOCK_B_CHOICES as QAIL_BLOCK_B_CHOICES,
)
from repro_torch.kernels.qail_update import qail_update as _qail_update
from repro_torch.kernels.ssd_chunk import SsdChunk as _SsdChunk
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.trace import traced

_DISPATCH = _obs_metrics.counter(
    "kernel_dispatch_total",
    "kernel dispatches by (kernel, tier, geometry)")


def _count(kernel: str, tier: str, **dims) -> None:
    geometry = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
    _DISPATCH.inc(kernel=kernel, tier=tier, geometry=geometry)


def _tier(x: torch.Tensor, use_kernel: bool | None) -> str:
    """``cuda`` for a CUDA tensor unless ``use_kernel`` is False (None, the
    reference's auto-dispatch, means the kernel on the accelerator);
    ``meta`` for a meta tensor (the dry run: the plain version, which on
    meta computes nothing); else ``torch-ref``."""
    if use_kernel is not False and x.device.type == "cuda":
        return "cuda"
    if x.device.type == "meta":
        return "meta"
    return "torch-ref"


# The query tiles an explicit block_b may name, by tunable kernel.
_CHOICES = {"encode_pack": _ef_mod.BLOCK_B_CHOICES,
            "am_search_packed": _asp_mod.BLOCK_B_CHOICES,
            "am_search_multibit": _asm_mod.BLOCK_B_CHOICES,
            "am_shortlist": _asl_mod.BLOCK_B_CHOICES,
            "am_search_sparse": _ass_mod.BLOCK_B_CHOICES,
            "qail_update": QAIL_BLOCK_B_CHOICES}


def _block_b(kernel: str, block_b: int) -> int:
    """An explicit query tile: one the kernel runs, else it raises."""
    choices = _CHOICES[kernel]
    if block_b not in choices:
        raise ValueError(f"{kernel}: block_b={block_b} not in {choices} "
                         f"(None: the tuned tile)")
    return block_b


def _cached(kernel: str, device: str, **dims) -> dict | None:
    """The autotune cache's entry for ``kernel`` at ``dims`` on the device
    named ``device``, or None; an entry the kernel cannot run (a block_b
    outside its choices; for encode_pack a tile that is not one of
    ``SGEMM_TILES`` of those rows; no ``tuned_batches``) raises."""
    geometry = _autotune.geometry_key(kernel, **dims)
    entry = _autotune.lookup(kernel, geometry, device)
    if entry is None:
        return None
    bb = entry.get("block_b")
    if kernel == "encode_pack":
        tile = entry.get("tile")
        ok = tile in range(len(SGEMM_TILES)) and bb == SGEMM_TILES[tile][0]
        runs = f"tile={tile}, block_b={bb}: no such SGEMM_TILES entry"
    else:
        ok = bb in _CHOICES[kernel]
        runs = f"block_b={bb} not in {_CHOICES[kernel]}"
    batches = entry.get("tuned_batches")
    if ok and not (batches and all(isinstance(b, int) and b > 0
                                   for b in batches)):
        ok, runs = False, f"tuned_batches={batches}: no batch range"
    if not ok:
        raise ValueError(
            f"{kernel}: the autotune cache {_autotune.cache_path()} holds "
            f"{runs} for {device} {geometry}, which the kernel cannot run")
    return entry


def tuned_block_b(kernel: str, block_b: int | None, **dims) -> int:
    """Resolve the batch tile for a dispatch: an explicit ``block_b`` wins
    (validated against the kernel's ``BLOCK_B_CHOICES``), then the
    autotune cache's entry for the current device and this geometry, then
    the kernel's default."""
    if block_b is not None:
        return _block_b(kernel, block_b)
    entry = _cached(kernel, _autotune.device_name(), **dims)
    if entry is not None:
        return int(entry["block_b"])
    return _autotune.KERNELS[kernel].default_block_b


_MISS = object()


def _tuned(kernel: str, index: int, dims: tuple) -> tuple | None:
    """(block_b, tile, least and most tuned batch) of the cached entry of
    ``kernel`` at ``dims`` (in its spec's ``key_dims`` order) on CUDA
    device ``index``, or None. Memoised in ``autotune.RESOLVED``, which
    ``autotune.save_entry`` clears: the cache path is read at a
    geometry's first dispatch, so a hit reads no environment and builds
    no key string."""
    key = (kernel, index, dims)
    tuned = _autotune.RESOLVED.get(key, _MISS)
    if tuned is not _MISS:
        return tuned
    name = _autotune.device_name(torch.device("cuda", index))
    entry = _cached(kernel, name,
                    **dict(zip(_autotune.KERNELS[kernel].key_dims, dims)))
    tuned = None
    if entry is not None:
        batches = entry["tuned_batches"]
        tuned = (int(entry["block_b"]), entry.get("tile"), min(batches),
                 max(batches))
    _autotune.RESOLVED[key] = tuned
    return tuned


def _resolve(kernel: str, block_b: int | None, x: torch.Tensor,
             *dims: int) -> tuple[int, int | None]:
    """(block_b, encode_pack's tile or None) of a dispatch of ``kernel``
    on ``x`` at ``dims`` (``key_dims`` order): an explicit tile,
    validated; for None on a CUDA tensor whose batch lies in the cached
    entry's tuned range, the entry's; else the kernel's default."""
    if block_b is not None:
        return _block_b(kernel, block_b), None
    index = x.get_device()
    if index >= 0:
        tuned = _tuned(kernel, index, dims)
        if tuned is not None and tuned[2] <= x.shape[0] <= tuned[3]:
            return tuned[0], tuned[1]
    return _autotune.KERNELS[kernel].default_block_b, None


def _encode_tile(x: torch.Tensor, f: int, d: int) -> int:
    """encode_pack's block tile (an index of ``SGEMM_TILES``) for
    block_b=None: the tuned one where ``_resolve`` finds it, else the
    default."""
    _, tile = _resolve("encode_pack", None, x, f, d)
    return SGEMM_TILE if tile is None else int(tile)


def _packed_block_b(block_b: int | None, x: torch.Tensor, mode: str,
                    d: int, c: int) -> int:
    """The packed search's query tile. The tuner times popcount mode
    only, so unpack mode runs an explicit tile or the default."""
    if mode != "popcount" and block_b is None:
        return _asp_mod.DEFAULT_BLOCK_B
    return _resolve("am_search_packed", block_b, x, d, c)[0]


def dispatch_breakdown() -> dict[str, dict[str, int]]:
    """{kernel: {tier: count}} summed over geometries."""
    out: dict[str, dict[str, int]] = {}
    series = sorted(((lab["kernel"], lab["tier"]), int(n))
                    for lab, n in _DISPATCH.series())
    for (k, t), n in series:
        out.setdefault(k, {})
        out[k][t] = out[k].get(t, 0) + n
    return out


def dispatch_batches(tier: str = "cuda") -> dict[str, dict[int, int]]:
    """{kernel: {B: count}} of the ``tier`` dispatches whose geometry has
    a batch B."""
    out: dict[str, dict[int, int]] = {}
    for lab, n in _DISPATCH.series():
        if lab["tier"] != tier:
            continue
        dims = dict(kv.split("=") for kv in lab["geometry"].split(",") if kv)
        if "B" in dims:
            per = out.setdefault(lab["kernel"], {})
            per[int(dims["B"])] = per.get(int(dims["B"]), 0) + int(n)
    return out


def reset_dispatch() -> None:
    _DISPATCH.clear()


def encode_mvm(feats: torch.Tensor, projection: torch.Tensor, *,
               use_kernel: bool | None = True) -> torch.Tensor:
    """Projection encoding H = F @ M through the IMC-geometry kernel.
    feats: (B, f); projection: (f, D) bipolar. Returns (B, D) float32."""
    tier = _tier(feats, use_kernel)
    _count("binary_mvm", tier, B=feats.shape[0], f=projection.shape[0],
           D=projection.shape[1])
    if tier != "cuda":
        return ref.binary_mvm(feats, projection)
    return _binary_mvm(feats.float().contiguous(), projection.float())


def encode_pack(feats: torch.Tensor, projection: torch.Tensor, *,
                use_kernel: bool | None = True,
                block_b: int | None = None) -> torch.Tensor:
    """Fused encode + sign + bitpack: (B, f) -> (B, ceil(D/8)) uint8.
    ``block_b``: the rows of the kernel's default block tile
    (``encode_fused.BLOCK_B_CHOICES``), or None for the tuned tile."""
    f, d = projection.shape
    tile = SGEMM_TILE
    if block_b is not None:
        _block_b("encode_pack", block_b)
    else:
        tile = _encode_tile(feats, f, d)
    tier = _tier(feats, use_kernel)
    _count("encode_pack", tier, B=feats.shape[0], f=f, D=d)
    if tier != "cuda":
        return ref.encode_pack(feats, projection)
    return _encode_pack_tiled(feats.float().contiguous(), projection, tile)


def search_from_features(feats: torch.Tensor, projection: torch.Tensor,
                         am_packed_t: torch.Tensor, *,
                         mode: str = "popcount",
                         use_kernel: bool | None = True,
                         block_b: int | None = None,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Feature -> search chain over the packed AM: (best_idx, best_sim).
    ``block_b``: the packed search's query tile (None: the tuned tiles of
    the encode and of the search)."""
    f, d = projection.shape
    c = am_packed_t.shape[1]
    tile = _encode_tile(feats, f, d)
    block_b = _packed_block_b(block_b, feats, mode, d, c)
    tier = _tier(feats, use_kernel)
    _count("search_from_features", tier, B=feats.shape[0], D=d, C=c)
    if tier != "cuda":
        qp = ref.encode_pack(feats, projection)
        return ref.am_search_packed(qp, am_packed_t, d)
    return _search_from_features(feats.float().contiguous(), projection,
                                 am_packed_t, mode=mode, block_b=block_b,
                                 tile=tile)


@traced("ops.predict_from_features")
def predict_from_features(feats: torch.Tensor, projection: torch.Tensor,
                          am_packed_t: torch.Tensor,
                          centroid_class: torch.Tensor, *,
                          mode: str = "popcount",
                          use_kernel: bool | None = True,
                          block_b: int | None = None) -> torch.Tensor:
    """End-to-end §III-D prediction from raw features: fused
    encode/pack -> packed search -> ownership gather (tiles as in
    ``search_from_features``)."""
    f, d = projection.shape
    c = am_packed_t.shape[1]
    tile = _encode_tile(feats, f, d)
    block_b = _packed_block_b(block_b, feats, mode, d, c)
    tier = _tier(feats, use_kernel)
    _count("predict_from_features", tier, B=feats.shape[0], D=d, C=c)
    if tier != "cuda":
        return ref.predict_from_features(feats, projection, am_packed_t,
                                         centroid_class)
    return _predict_from_features(feats.float().contiguous(), projection,
                                  am_packed_t, centroid_class, mode=mode,
                                  block_b=block_b, tile=tile)


def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor, *,
                     n_dims: int, mode: str = "popcount",
                     use_kernel: bool | None = True,
                     block_b: int | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the packed 1-bit AM. ``block_b``:
    the query tile, one of ``am_search_packed.BLOCK_B_CHOICES`` (None:
    the tuned tile)."""
    block_b = _packed_block_b(block_b, q_packed, mode, n_dims,
                              am_packed_t.shape[1])
    tier = _tier(q_packed, use_kernel)
    _count("am_search_packed", tier, B=q_packed.shape[0], D=n_dims,
           C=am_packed_t.shape[1])
    if tier != "cuda":
        if mode == "unpack":
            return ref.am_search_packed_unpack(q_packed, am_packed_t, n_dims)
        return ref.am_search_packed(q_packed, am_packed_t, n_dims)
    return _am_search_packed(q_packed, am_packed_t, n_dims=n_dims,
                             mode=mode, block_b=block_b)


@traced("ops.am_shortlist")
def am_shortlist(q_packed: torch.Tensor, super_packed_t: torch.Tensor, *,
                 n_dims: int, s: int, use_kernel: bool | None = True,
                 block_b: int | None = None,
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse pass of the hierarchical search: ((B, s) cluster ids,
    (B, s) super similarities), best first, ties toward the lower
    cluster id. ``block_b``: the rows of the kernel's query tile
    (``am_shortlist.BLOCK_B_CHOICES``) or None."""
    if block_b is not None:
        _block_b("am_shortlist", block_b)
    tier = _tier(q_packed, use_kernel)
    _count("am_shortlist", tier, B=q_packed.shape[0], D=n_dims,
           G=super_packed_t.shape[1], S=s)
    if tier != "cuda":
        return ref.am_shortlist(q_packed, super_packed_t, n_dims, s)
    return _am_shortlist(q_packed, super_packed_t, n_dims=n_dims, s=s)


@traced("ops.am_search_sparse")
def am_search_sparse(q_packed: torch.Tensor, am_slab_t: torch.Tensor,
                     col_ids: torch.Tensor, shortlist: torch.Tensor,
                     tile_start: torch.Tensor, tile_count: torch.Tensor, *,
                     n_dims: int, k: int, max_tiles: int,
                     use_kernel: bool | None = True,
                     block_b: int | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine pass of the hierarchical search over the cluster-contiguous
    slab (``deploy.hierarchical.build_layout``): ((B, k) original
    centroid ids, (B, k) sims) by (-sim, id); exhausted slots (-1,
    float32-min). With S = G the k = 1 column equals
    ``am_search_packed``. The CUDA kernel reads the shortlisted tiles
    through the layout; the plain tier gathers them first. ``block_b``:
    queries per block (``am_search_sparse.BLOCK_B_CHOICES``) or None."""
    if block_b is not None:
        _block_b("am_search_sparse", block_b)
    tier = _tier(q_packed, use_kernel)
    _count("am_search_sparse", tier, B=q_packed.shape[0], D=n_dims,
           S=shortlist.shape[1], K=k)
    if tier != "cuda":
        return am_search_sparse_plain(
            q_packed, am_slab_t, col_ids, shortlist, tile_start, tile_count,
            n_dims=n_dims, k=k, max_tiles=max_tiles)
    return _am_search_sparse(q_packed, am_slab_t, col_ids, shortlist,
                             tile_start, tile_count, n_dims=n_dims, k=k,
                             max_tiles=max_tiles)


@traced("ops.pack_rows")
def pack_rows(x: torch.Tensor, *,
              use_kernel: bool | None = True) -> torch.Tensor:
    """(B, D) bipolar -> (B, ceil(D/8)) uint8, any D (tail bits 0)."""
    tier = _tier(x, use_kernel)
    _count("pack_rows", tier, B=x.shape[0], D=x.shape[1])
    if tier != "cuda":
        return ref.pack_rows(x)
    return _pack_rows(x)


def pack_bits(x: torch.Tensor, *,
              use_kernel: bool | None = True) -> torch.Tensor:
    """(R, C) bipolar, C % 8 == 0 -> (R, C // 8) uint8."""
    tier = _tier(x, use_kernel)
    _count("pack_bits", tier, R=x.shape[0], C=x.shape[1])
    if tier != "cuda":
        return ref.pack_bits(x)
    return _pack_bits(x.float().contiguous())


def unpack_bits(p: torch.Tensor, *, use_kernel: bool | None = True,
                ) -> torch.Tensor:
    """(R, C // 8) uint8 -> (R, C) float32 {-1, +1}."""
    tier = _tier(p, use_kernel)
    _count("unpack_bits", tier, R=p.shape[0], C=p.shape[1] * 8)
    if tier != "cuda":
        return ref.unpack_bits(p)
    return _unpack_bits(p.contiguous())


def predict_packed(queries: torch.Tensor, am_packed_t: torch.Tensor,
                   centroid_class: torch.Tensor, *, n_dims: int,
                   mode: str = "popcount",
                   use_kernel: bool | None = True,
                   ) -> torch.Tensor:
    """§III-D prediction over the packed residence: pack the bipolar
    queries, XOR+popcount search, ownership lookup."""
    qp = pack_rows(queries, use_kernel=use_kernel)
    idx, _ = am_search_packed(qp, am_packed_t, n_dims=n_dims, mode=mode,
                              use_kernel=use_kernel)
    return centroid_class[idx.long()]


def am_search(queries: torch.Tensor, am: torch.Tensor, *,
              use_kernel: bool | None = True,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search. queries: (B, D); am: (C, D) bipolar
    centroid rows, searched through its (D, C) transposed view (no
    copy). Returns (best_idx (B,) int32, best_sim (B,) float32)."""
    tier = _tier(queries, use_kernel)
    _count("am_search", tier, B=queries.shape[0], D=queries.shape[1],
           C=am.shape[0])
    if tier != "cuda":
        return ref.am_search(queries, am.T)
    return _am_search(queries.float().contiguous(), am.float().T)


def predict_classes(queries: torch.Tensor, am: torch.Tensor,
                    centroid_class: torch.Tensor, *,
                    use_kernel: bool | None = True) -> torch.Tensor:
    """End-to-end §III-D prediction: search + ownership lookup."""
    idx, _ = am_search(queries, am, use_kernel=use_kernel)
    return centroid_class[idx.long()]


@traced("ops.am_search_imc")
def am_search_imc(queries: torch.Tensor, am: torch.Tensor, *, sim,
                  offsets: torch.Tensor | None = None,
                  use_kernel: bool | None = True,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-fidelity associative search (tiled analog MVM + ADC).

    queries: (B, D); am: (C, D) resident centroid rows — typically the
    perturbed device instance of ``imcsim.device.perturb_am`` — searched
    through its (D, C) transposed view; sim: an ``ImcSimConfig`` (array
    geometry + ADC); offsets: optional per-array readout drift grid.
    With an ideal sim the result equals ``am_search`` bit for bit.
    Returns (best_idx (B,) int32, best_sim (B,) float32).
    """
    tier = _tier(queries, use_kernel)
    _count("am_search_imc", tier, B=queries.shape[0], D=queries.shape[1],
           C=am.shape[0])
    kw = dict(tile_rows=sim.arr.rows, tile_cols=sim.arr.cols,
              adc_bits=sim.adc_bits, adc_clip=sim.clip)
    if tier != "cuda":
        return ref.am_search_imc(queries, am.T, offsets=offsets, **kw)
    return _am_search_imc(queries.float().contiguous(), am.float().T,
                          offsets, **kw)


def am_search_multibit(queries: torch.Tensor, am_planes_t: torch.Tensor, *,
                       sim=None, scale: torch.Tensor | None = None,
                       offsets: torch.Tensor | None = None,
                       use_kernel: bool | None = True,
                       block_b: int | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sliced associative search over the multi-bit packed AM.

    queries: (B, D) bipolar; am_planes_t: (cell_bits, Dp, C) uint8
    offset-code planes (``core.am.pack_am_planes``); sim: optional
    ``ImcSimConfig`` for the array geometry and ADC (default: 128x128,
    16 bits, ``ref.multibit_adc_clip``); scale: optional quantizer scale,
    which dequantizes the returned similarity (idx does not depend on
    it); offsets: optional per-array code-domain drift grid; block_b:
    the kernel's query tile (``am_search_multibit.BLOCK_B_CHOICES``) or
    None. Returns (best_idx (B,) int32, best_sim (B,) float32).
    """
    cell_bits = int(am_planes_t.shape[0])
    if block_b is not None:
        _block_b("am_search_multibit", block_b)
    tile_rows = sim.arr.rows if sim is not None else 128
    tile_cols = sim.arr.cols if sim is not None else 128
    adc_bits = sim.adc_bits if sim is not None else 16
    # Not sim.clip: that defaults to the 1-bit bound (the row count);
    # multi-bit partial sums need the Qmax-scaled full scale.
    adc_clip = (sim.adc_clip
                if sim is not None and sim.adc_clip is not None
                else ref.multibit_adc_clip(cell_bits, tile_rows))
    tier = _tier(queries, use_kernel)
    _count("am_search_multibit", tier, B=queries.shape[0],
           D=queries.shape[1], C=am_planes_t.shape[2], bits=cell_bits)
    kw = dict(cell_bits=cell_bits, tile_rows=tile_rows, tile_cols=tile_cols,
              adc_bits=adc_bits, adc_clip=float(adc_clip))
    if tier != "cuda":
        idx, s = ref.am_search_multibit(queries, am_planes_t,
                                        offsets=offsets, **kw)
    else:
        idx, s = _am_search_multibit(queries.float().contiguous(),
                                     am_planes_t.contiguous(), offsets, **kw)
    if scale is not None:
        s = s * torch.as_tensor(scale, dtype=torch.float32, device=s.device)
    return idx, s


def qail_update(q: torch.Tensor, upd: torch.Tensor, am_t: torch.Tensor,
                centroid_class: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, *, lr: float,
                use_kernel: bool | None = True,
                block_b: int | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused QAIL inner step (§III-C): sims + Eq. 4/5 + Eq.-(6) delta.

    q/upd: (B, D); am_t: (D, C) transposed binary AM (a view is fine);
    labels/mask: (B,). Returns (delta (C, D) float32, n_miss float32).
    ``block_b``: queries per similarity tile of the kernel, one of
    ``QAIL_BLOCK_B_CHOICES`` (None: the tuned tile); any choice gives the
    same result.
    """
    block_b, _ = _resolve("qail_update", block_b, q, am_t.shape[0],
                          am_t.shape[1])
    tier = _tier(q, use_kernel)
    _count("qail_update", tier, B=q.shape[0], D=am_t.shape[0],
           C=am_t.shape[1])
    if tier != "cuda":
        return ref.qail_update_delta(q, upd, am_t, centroid_class, labels,
                                     mask, lr)
    return _qail_update(q.float().contiguous(), upd.float().contiguous(),
                        am_t.float(), centroid_class.to(torch.int32),
                        labels.to(torch.int32), mask.float(), lr=lr,
                        block_b=block_b)


@traced("ops.predict_imc")
def predict_imc(queries: torch.Tensor, am: torch.Tensor,
                centroid_class: torch.Tensor, *, sim,
                offsets: torch.Tensor | None = None,
                use_kernel: bool | None = True) -> torch.Tensor:
    """§III-D prediction through the simulated analog readout: tiled
    analog search + ADC + ownership lookup."""
    idx, _ = am_search_imc(queries, am, sim=sim, offsets=offsets,
                           use_kernel=use_kernel)
    return centroid_class[idx.long()]


def predict_multibit(queries: torch.Tensor, am_planes_t: torch.Tensor,
                     centroid_class: torch.Tensor, *, sim=None,
                     offsets: torch.Tensor | None = None,
                     use_kernel: bool | None = True) -> torch.Tensor:
    """§III-D prediction over the multi-bit residence: bit-sliced
    code-domain search + ownership lookup (argmax does not depend on the
    quantizer scale)."""
    idx, _ = am_search_multibit(queries, am_planes_t, sim=sim,
                                offsets=offsets, use_kernel=use_kernel)
    return centroid_class[idx.long()]


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                 softcap: float | None = None,
                 use_kernel: bool | None = True, return_lse: bool = False):
    """One-token GQA attention over a length-masked KV cache (the decode
    step's attention). q: (B, H, Dh); k_cache/v_cache: (B, S, KV, Dh),
    not head-repeated; cache_len: (B,) valid keys per row; ``softcap``
    caps the scaled scores (cap * tanh(s / cap)). Returns (B, H, Dh) in
    q's dtype; float32 softmax and P @ V. ``return_lse`` returns (out,
    lse): out unrounded in float32 and each row's log-sum-exp of its
    scores, (B, H) float32 (-inf for a row with ``cache_len`` 0): a
    sequence shard's partial."""
    tier = _tier(q, use_kernel)
    _count("flash_decode", tier, B=q.shape[0], H=q.shape[1],
           KV=k_cache.shape[2], S=k_cache.shape[1], Dh=q.shape[2])
    if tier != "cuda":
        return ref.flash_decode(q, k_cache, v_cache, cache_len, softcap,
                                return_lse)
    return _flash_decode(q.contiguous(), k_cache.contiguous(),
                         v_cache.contiguous(),
                         cache_len.to(torch.int32).contiguous(),
                         softcap=softcap, return_lse=return_lse)


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              dt: torch.Tensor, da: torch.Tensor, state: torch.Tensor, *,
              use_kernel: bool | None = True,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Mamba-2 SSD chunk for every (batch, head): x (B, Q, H, P),
    b/c (B, Q, H, N), dt/da (B, Q, H), state (B, H, N, P) entering the
    chunk. Returns (y in x's dtype, the float32 state leaving it).

    Both tiers are differentiable: the plain one under autograd, the
    kernel through ``ssd_chunk.SsdChunk`` (kernel forward, the plain
    version's VJP), in and out of grad mode alike."""
    tier = _tier(x, use_kernel)
    _count("ssd_chunk", tier, B=x.shape[0], Q=x.shape[1], H=x.shape[2],
           N=b.shape[3], P=x.shape[3])
    if tier != "cuda":
        return ref.ssd_chunk(x, b, c, dt, da, state)
    rows = [t if t.shape[0] == 0 or t[0].is_contiguous() else t.contiguous()
            for t in (x, b, c, dt.float(), da.float())]
    return _SsdChunk.apply(*rows, state.float().contiguous())
