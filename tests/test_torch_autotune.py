"""The port's autotuner (``repro_torch.kernels.autotune``) and the tuned
dispatch of ``kernels.ops`` against the reference's, on the CPU.

The CPU run checks what does not need the card: the cache's round trip
under ``MEMHD_TORCH_AUTOTUNE_CACHE``, the lookup order of
``ops.tuned_block_b`` (explicit tile, cached entry, default), that a
cached tile the kernel cannot run raises naming the cache file, that
candidates with one launch plan are timed once, that the geometry keys and
``tuned_block_b``'s signature are the reference's, and that each spec's
plain version equals the reference's oracle on the same numpy inputs.
On the CPU the plain versions ignore the configuration, so the tuner's
parity check runs but its times say nothing; the card tests
(``tests/test_torch_cuda.py``) hold every candidate against the plain
version on the GPU.
"""
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import autotune as jautotune  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import autotune, ops, ref  # noqa: E402
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import binary_mvm as bm  # noqa: E402

# A small geometry per spec (the reference's first default, cut where the
# CPU's plain version would be slow).
SMALL = {"am_search_multibit": {"D": 128, "C": 96, "bits": 4},
         "am_search_packed": {"D": 128, "C": 128},
         "am_shortlist": {"D": 128, "G": 16, "S": 8},
         "am_search_sparse": {"D": 128, "T": 2, "K": 3},
         "encode_pack": {"f": 100, "D": 128},
         "qail_update": {"D": 128, "C": 64}}


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "autotune_cache.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    return path


def _to_jax(args):
    return [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
            for a in args]


def _flat(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def test_the_specs_are_the_references():
    assert set(autotune.KERNELS) == set(jautotune.KERNELS)
    for name, spec in autotune.KERNELS.items():
        assert spec.key_dims == jautotune.KERNELS[name].key_dims, name
        assert set(spec.candidates) >= {spec.default_candidate}
    assert autotune.CACHE_ENV != jautotune.CACHE_ENV


def test_each_kernel_tunes_at_its_paths_batch(cache):
    """The geometry key has no batch, and the winner depends on it: the
    serving kernels tune at the batches the serving paths dispatch (a
    served request of 32 rows up to the served 1024), qail_update at the
    256-row QAIL minibatch and its shards on two and four devices."""
    batches = {k: spec.batches for k, spec in autotune.KERNELS.items()}
    serve = (32, 256, 512, 1024)
    assert batches == {"am_search_packed": serve, "encode_pack": serve,
                       "am_search_multibit": serve, "am_shortlist": serve,
                       "am_search_sparse": serve,
                       "qail_update": (64, 128, 256)}
    from repro_torch.core.types import MemhdConfig
    bs = MemhdConfig(dim=8, columns=8, classes=2).batch_size
    assert batches["qail_update"] == (bs // 4, bs // 2, bs)
    entry = autotune.autotune_kernel("qail_update", SMALL["qail_update"],
                                     device="cpu")
    assert entry["tuned_batches"] == [64, 128, 256]
    assert set(entry["best_us"]) == {"64", "128", "256"}
    assert set(entry["plan"]) == {"64", "128", "256"}
    entry = autotune.autotune_kernel("qail_update", SMALL["qail_update"],
                                     batches=(40,), device="cpu")
    assert entry["tuned_batches"] == [40]


@pytest.mark.parametrize("times,want", [
    # One candidate beats the default at every batch: it wins.
    ({"3": {32: 5.0, 1024: 9.0}, "1": {32: 4.0, 1024: 8.0}}, "1"),
    # Faster at one batch, slower at another: the default stays.
    ({"3": {32: 5.0, 1024: 9.0}, "1": {32: 4.0, 1024: 9.5}}, "3"),
    # A tie at one batch is no win.
    ({"3": {32: 5.0, 1024: 9.0}, "1": {32: 4.0, 1024: 9.0}}, "3"),
    # Of two that win everywhere, the least mean time relative to the
    # default.
    ({"3": {32: 5.0, 1024: 9.0}, "1": {32: 2.5, 1024: 8.9},
      "0": {32: 4.5, 1024: 8.0}}, "1"),
])
def test_a_tile_other_than_the_default_must_win_at_every_batch(times, want):
    assert autotune._pick(times, "3", (32, 1024)) == want


def test_with_no_default_timed_the_fastest_wins():
    times = {"1": {32: 4.0, 1024: 8.0}, "2": {32: 3.0, 1024: 8.5}}
    assert autotune._pick(times, None, (32, 1024)) == "2"


def test_default_geometries_extend_the_references():
    for name, geoms in jautotune.DEFAULT_GEOMETRIES.items():
        assert list(geoms) == list(autotune.DEFAULT_GEOMETRIES[name][
            :len(geoms)]), name
    port = autotune.DEFAULT_GEOMETRIES
    assert {"D": 1024, "C": 1024} in port["am_search_packed"]
    assert {"D": 1024, "C": 1024} in port["qail_update"]
    assert {"f": 784, "D": 1024} in port["encode_pack"]
    assert {"D": 1024, "C": 1024, "bits": 4} in port["am_search_multibit"]
    assert {"D": 1024, "G": 45, "S": 45} in port["am_shortlist"]
    assert {"D": 1024, "G": 448, "S": 8} in port["am_shortlist"]
    for k in (1, 5):
        assert {"D": 1024, "T": 16, "K": k} in port["am_search_sparse"]


@pytest.mark.parametrize("name", sorted(autotune.KERNELS))
def test_geometry_key_is_the_references(name):
    for dims in (autotune.DEFAULT_GEOMETRIES[name]
                 + jautotune.DEFAULT_GEOMETRIES[name] + (SMALL[name],)):
        assert (autotune.geometry_key(name, **dims)
                == jautotune.geometry_key(name, **dims))
    with pytest.raises(KeyError, match="missing"):
        autotune.geometry_key(name)


def test_tuned_block_b_signature_is_the_references():
    assert (inspect.signature(ops.tuned_block_b)
            == inspect.signature(jops.tuned_block_b))
    assert (inspect.signature(autotune.tuned_block_b)
            == inspect.signature(jautotune.tuned_block_b))


@pytest.mark.parametrize("name", sorted(autotune.KERNELS))
def test_plain_version_equals_the_reference_oracle(name):
    """Each spec's run_ref (the port's plain version) on the inputs its
    make_inputs builds from a numpy seed equals the reference spec's
    run_ref (its ref.py oracle) on the same values."""
    spec, jspec = autotune.KERNELS[name], jautotune.KERNELS[name]
    args = spec.make_inputs(np.random.default_rng(3), 24, SMALL[name], "cpu")
    got = _flat(spec.run_ref(*args))
    want = _flat(jspec.run_ref(*_to_jax(args)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", sorted(autotune.KERNELS))
def test_tuned_equals_default_for_every_spec(name, cache):
    """The tuner's entry at a small geometry (every candidate parity-
    checked against the plain version first), then the tuned and the
    default configuration give the same outputs."""
    spec = autotune.KERNELS[name]
    dims = SMALL[name]
    entry = autotune.autotune_kernel(name, dims, batches=(24, 40),
                                     device="cpu")
    assert entry["device"] == "cpu" and entry["power_limit_w"] is None
    assert entry["geometry"] == autotune.geometry_key(name, **dims)
    assert "cpu wall clock" in entry["timing"]
    assert entry["block_b"] == spec.block_b_of(
        entry.get("tile", entry["block_b"]))
    assert autotune.lookup(name, entry["geometry"], "cpu") == entry
    args = spec.make_inputs(np.random.default_rng(0), 24, dims, "cpu")
    best = entry.get("tile", entry["block_b"])
    for g, w in zip(_flat(spec.run(best, *args)),
                    _flat(spec.run(spec.default_candidate, *args))):
        assert torch.equal(g, w)
    assert ops.tuned_block_b(name, None, **dims) == entry["block_b"]


def test_cache_round_trip(cache):
    entry = autotune.autotune_kernel("qail_update", SMALL["qail_update"],
                                     batches=(16,), device="cpu")
    assert cache.exists()
    data = json.loads(cache.read_text())
    assert data["schema_version"] == autotune.SCHEMA_VERSION
    key = f"qail_update|cpu|{entry['geometry']}"
    assert data["entries"][key] == entry
    assert autotune.load_cache() == data["entries"]
    assert autotune.lookup("qail_update", entry["geometry"], "cpu") == entry
    assert autotune.tuned_block_b("qail_update",
                                  **SMALL["qail_update"]) == entry["block_b"]
    # A second entry keeps the first; another device's name misses.
    e2 = autotune.autotune_kernel("encode_pack", SMALL["encode_pack"],
                                  batches=(16,), device="cpu")
    assert len(autotune.load_cache()) == 2
    assert e2["tile"] in range(len(bm.SGEMM_TILES))
    assert autotune.lookup("qail_update", entry["geometry"],
                           "NVIDIA H100 80GB HBM3") is None
    autotune.main(["--kernel", "am_shortlist", "--device", "cpu",
                   "--batches", "16,24"])
    assert sum(k.startswith("am_shortlist|cpu|")
               for k in autotune.load_cache()) == len(
        autotune.DEFAULT_GEOMETRIES["am_shortlist"])


@pytest.mark.parametrize("name", sorted(autotune.KERNELS))
def test_lookup_miss_gives_the_default(name, cache):
    dims = SMALL[name]
    assert ops.tuned_block_b(name, None, **dims) == \
        autotune.KERNELS[name].default_block_b
    assert autotune.tuned_block_b(name, **dims) == \
        autotune.KERNELS[name].default_block_b
    assert ops._cached(name, "NVIDIA H100 80GB HBM3", **dims) is None


def test_explicit_tile_wins_and_is_validated(cache):
    autotune.save_entry({"kernel": "am_search_packed", "device": "cpu",
                         "geometry": "D128_C128", "block_b": 32,
                         "tuned_batches": [32, 1024]})
    assert ops.tuned_block_b("am_search_packed", None, D=128, C=128) == 32
    assert ops.tuned_block_b("am_search_packed", 16, D=128, C=128) == 16
    with pytest.raises(ValueError, match=r"block_b=64 not in \("):
        ops.tuned_block_b("am_search_packed", 64, D=128, C=128)


@pytest.mark.parametrize("name,bad", [
    ("am_search_packed", {"block_b": 64}),
    ("qail_update", {"block_b": 8}),
    ("am_search_multibit", {"block_b": 128}),
    ("am_shortlist", {"block_b": 32}),
    ("am_search_sparse", {"block_b": 2}),
    ("encode_pack", {"block_b": 64, "tile": 7}),
    ("encode_pack", {"block_b": 128, "tile": 3}),
    ("am_search_packed", {"block_b": 32, "tuned_batches": []}),
    ("qail_update", {"block_b": 32, "tuned_batches": [0, 256]}),
])
def test_a_cached_tile_the_kernel_cannot_run_raises(name, bad, cache):
    dims = SMALL[name]
    geometry = autotune.geometry_key(name, **dims)
    for device in ("cpu", "NVIDIA H100 80GB HBM3"):
        autotune.save_entry({"kernel": name, "device": device,
                             "geometry": geometry, "tuned_batches": [32],
                             **bad})
    with pytest.raises(ValueError, match=str(cache)):
        ops.tuned_block_b(name, None, **dims)
    # The lookup a dispatch on that card makes.
    with pytest.raises(ValueError, match="cannot run"):
        ops._cached(name, "NVIDIA H100 80GB HBM3", **dims)


def test_cpu_dispatch_reads_no_cache(cache):
    """On the CPU the plain tier has no tile: block_b=None dispatches
    never consult the cache (a bad entry for the CPU does not matter),
    and an explicit tile is still validated."""
    autotune.save_entry({"kernel": "am_search_packed", "device": "cpu",
                         "geometry": "D128_C128", "block_b": 64})
    rng = np.random.default_rng(1)
    q = torch.as_tensor(rng.choice([-1.0, 1.0], (5, 128)), dtype=torch.float32)
    am = torch.as_tensor(rng.choice([-1.0, 1.0], (128, 128)),
                         dtype=torch.float32)
    qp, amt = ref.pack_rows(q), ref.pack_rows(am).T.contiguous()
    idx, sim = ops.am_search_packed(qp, amt, n_dims=128)
    w_idx, w_sim = ref.am_search_packed(qp, amt, 128)
    assert torch.equal(idx, w_idx) and torch.equal(sim, w_sim)
    with pytest.raises(ValueError, match=r"block_b=64 not in \("):
        ops.am_search_packed(qp, amt, n_dims=128, block_b=64)


def test_same_plan_candidates_are_timed_once(cache, monkeypatch):
    """4, 8 and 16 give one 16-row launch: only 4 (and 32) are timed and
    parity-checked; the entry maps the others to it."""
    timed = []
    real = autotune._time_wall_ms

    def counting(fn, iters=3):
        timed.append(fn)
        return real(fn, iters)

    monkeypatch.setattr(autotune, "_time_wall_ms", counting)
    entry = autotune.autotune_kernel("am_search_packed",
                                     {"D": 1024, "C": 1024}, batches=(64,),
                                     device="cpu")
    assert len(timed) == 2
    assert set(entry["candidates_us"]) == {"4", "32"}
    assert entry["same_plan"] == {"8": "4", "16": "4"}
    assert entry["default_us"] == entry["candidates_us"]["4"]
    plans = {bb: asp.launch_plan(64, 128, 1024, bb, "popcount",
                                 autotune.HOPPER_SMS)
             for bb in asp.BLOCK_B_CHOICES}
    assert plans[4] == plans[8] == plans[16] != plans[32]
    assert entry["plan"] == {"64": plans[entry["block_b"]]}


def test_candidates_over_the_shared_memory_limit_are_skipped(cache):
    spec = autotune.KERNELS["qail_update"]
    dims = SMALL["qail_update"]
    smem = {bb: spec.plan(bb, 16, dims, autotune.HOPPER_SMS)["smem"]
            for bb in spec.candidates}
    assert smem[16] < smem[32] < smem[64]
    entry = autotune.autotune_kernel("qail_update", dims, batches=(16,),
                                     device="cpu", smem_limit=smem[32])
    assert entry["skipped_smem"] == {"64": smem[64]}
    assert set(entry["candidates_us"]) == {"16", "32"}
    assert entry["smem_limit_bytes"] == smem[32]
    with pytest.raises(RuntimeError, match="shared memory"):
        autotune.autotune_kernel("qail_update", dims, batches=(16,),
                                 device="cpu", smem_limit=smem[16] - 1)


def test_encode_pack_candidates_are_the_sgemm_tiles(cache):
    spec = autotune.KERNELS["encode_pack"]
    assert spec.candidates == tuple(range(len(bm.SGEMM_TILES)))
    assert spec.default_candidate == bm.SGEMM_TILE
    assert spec.default_block_b == bm.SGEMM_TILES[bm.SGEMM_TILE][0]
    for tile, shape in enumerate(bm.SGEMM_TILES):
        plan = spec.plan(tile, 100, {"f": 784, "D": 1024}, 132)
        assert plan["smem"] == 4 * 3 * (shape[0] * shape[4]
                                        + shape[4] * shape[1])
        assert spec.block_b_of(tile) == shape[0]


class _OnCard:
    """A stand-in for a CUDA tensor of ``rows`` rows: what ``ops`` reads of
    a dispatch's operand to resolve its tile (its device and batch)."""

    def __init__(self, rows):
        self.shape = (rows, 128)

    def get_device(self):
        return 0


CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def on_card(cache, monkeypatch):
    """The cache keyed by a card's name, that name for device 0, and an
    empty memo of resolved tiles."""
    monkeypatch.setitem(autotune._NAMES, 0, CARD)
    monkeypatch.setattr(autotune, "RESOLVED", {})
    for kernel, geometry, fields in (
            ("am_search_packed", "D128_C128", {"block_b": 32}),
            ("encode_pack", "f100_D128", {"block_b": 64, "tile": 1}),
            ("qail_update", "D128_C64", {"block_b": 64})):
        autotune.save_entry({"kernel": kernel, "device": CARD,
                             "geometry": geometry, "tuned_batches": [32, 1024]
                             if kernel != "qail_update" else [64, 256],
                             **fields})
    return cache


@pytest.mark.parametrize("rows,want", [(8, 8), (31, 8), (32, 32), (500, 32),
                                       (1024, 32), (1025, 8)])
def test_the_tuned_tile_applies_only_inside_the_tuned_batches(on_card, rows,
                                                              want):
    x = _OnCard(rows)
    assert ops._packed_block_b(None, x, "popcount", 128, 128) == want
    tile = 1 if want == 32 else bm.SGEMM_TILE
    assert ops._encode_tile(x, 100, 128) == tile
    assert ops._resolve("qail_update", None, x, 128, 64)[0] == (
        64 if 64 <= rows <= 256 else 16)


def test_unpack_mode_and_an_explicit_tile_ignore_the_cache(on_card):
    x = _OnCard(1024)
    assert ops._packed_block_b(None, x, "unpack", 128, 128) == \
        asp.DEFAULT_BLOCK_B
    assert ops._packed_block_b(16, x, "popcount", 128, 128) == 16
    assert ops._packed_block_b(4, x, "unpack", 128, 128) == 4
    with pytest.raises(ValueError, match=r"block_b=64 not in \("):
        ops._packed_block_b(64, x, "unpack", 128, 128)


def test_a_dispatch_reads_the_cache_once(on_card, monkeypatch):
    """The first dispatch memoises the entry's tile; later ones make no
    lookup and read no environment, and save_entry clears the memo."""
    x = _OnCard(256)
    assert ops._packed_block_b(None, x, "popcount", 128, 128) == 32
    assert len(autotune.RESOLVED) == 1

    def no_lookup(*args, **kwargs):
        raise AssertionError("a memoised dispatch looked the cache up")

    real = autotune.lookup, autotune.cache_path
    monkeypatch.setattr(autotune, "lookup", no_lookup)
    monkeypatch.setattr(autotune, "cache_path", no_lookup)
    for _ in range(3):
        assert ops._packed_block_b(None, x, "popcount", 128, 128) == 32
    monkeypatch.setattr(autotune, "lookup", real[0])
    monkeypatch.setattr(autotune, "cache_path", real[1])
    autotune.save_entry({"kernel": "am_search_packed", "device": CARD,
                         "geometry": "D128_C128", "block_b": 16,
                         "tuned_batches": [32, 1024]})
    assert autotune.RESOLVED == {}
    assert ops._packed_block_b(None, x, "popcount", 128, 128) == 16
    # A miss is memoised too, and an entry it cannot run raises each time.
    assert ops._packed_block_b(None, x, "popcount", 128, 256) == 8
    assert len(autotune.RESOLVED) == 2
    autotune.save_entry({"kernel": "am_search_packed", "device": CARD,
                         "geometry": "D128_C128", "block_b": 64,
                         "tuned_batches": [32]})
    for _ in range(2):
        with pytest.raises(ValueError, match="cannot run"):
            ops._packed_block_b(None, x, "popcount", 128, 128)


def test_single_configuration_kernels_read_no_cache(on_card, monkeypatch):
    """am_shortlist, am_search_sparse and am_search_multibit run one
    configuration: their dispatch validates an explicit tile and reads no
    cache entry, so a bad one decides nothing."""
    for name in ("am_search_multibit", "am_shortlist", "am_search_sparse"):
        autotune.save_entry({"kernel": name, "device": "cpu",
                             "geometry": autotune.geometry_key(
                                 name, **SMALL[name]), "block_b": 999,
                             "tuned_batches": [32]})

    def no_lookup(*args, **kwargs):
        raise AssertionError("a single-configuration dispatch read the cache")

    monkeypatch.setattr(autotune, "lookup", no_lookup)
    rng = np.random.default_rng(2)
    q = torch.as_tensor(rng.choice([-1.0, 1.0], (5, 128)), dtype=torch.float32)
    sup = torch.as_tensor(rng.choice([-1.0, 1.0], (16, 128)),
                          dtype=torch.float32)
    qp, spt = ref.pack_rows(q), ref.pack_rows(sup).T.contiguous()
    ids, sims = ops.am_shortlist(qp, spt, n_dims=128, s=8)
    w_ids, w_sims = ref.am_shortlist(qp, spt, 128, 8)
    assert torch.equal(ids, w_ids) and torch.equal(sims, w_sims)
    with pytest.raises(ValueError, match=r"block_b=32 not in \("):
        ops.am_shortlist(qp, spt, n_dims=128, s=8, block_b=32)
    spec = autotune.KERNELS["am_search_multibit"]
    mq, planes, bits = spec.make_inputs(rng, 5, SMALL["am_search_multibit"],
                                        "cpu")
    idx, _ = ops.am_search_multibit(mq, planes)
    assert torch.equal(idx, spec.run_ref(mq, planes, bits)[0])
    with pytest.raises(ValueError, match=r"block_b=128 not in \("):
        ops.am_search_multibit(mq, planes, block_b=128)
