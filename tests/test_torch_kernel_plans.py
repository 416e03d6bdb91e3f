"""The pure-Python launch planning of the port's wrappers, on the CPU.

``flash_decode``'s split of S and shared-memory count, the block tiles
of the fp32 mainloop that ``binary_mvm`` and ``encode_pack`` share
(``csrc/sgemm_tile.cuh``), ``ssd_chunk``'s grid and shared memory,
``qail_update``'s tiles and scratch, and a rounding model of the split
products ``ssd_chunk`` runs on the tensor cores. The kernels themselves
run only on the card (``tests/test_torch_cuda.py``).
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import binary_mvm as bm  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import qail_update as qu  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402


def _chip_smoke():
    """chip_smoke.py's constants (it imports torch only inside functions)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()

FD_DTYPES = (torch.float32, torch.bfloat16)
TILE = {torch.float32: fd.SIMT_TILE, torch.bfloat16: fd.MMA_TILE}
MIN_SPLIT = {torch.float32: fd.SIMT_MIN_SPLIT,
             torch.bfloat16: fd.MMA_MIN_SPLIT}


@pytest.mark.parametrize("dtype", FD_DTYPES)
@pytest.mark.parametrize("sms", [1, 16, 132])
def test_flash_decode_splits_cover_s_and_none_is_empty(dtype, sms):
    for b, kv, groups, dh in itertools.product((1, 4, 8), (1, 5), (1, 5, 33),
                                               (20, 64, 256)):
        for s in (1, 15, 63, 64, 65, 320, 4097, 32768, 100_003):
            n, length = fd.split_plan(b, kv, s, sms, dtype=dtype,
                                      groups=groups, dh=dh)
            assert length % TILE[dtype] == 0
            assert length >= MIN_SPLIT[dtype]
            assert n * length >= s > (n - 1) * length


def test_flash_decode_bf16_fills_one_wave_at_the_row_shape():
    """B 8, S 32,768, KV 5, Dh 64: 4 blocks of 51.2 KB per SM, one wave
    of at most 4 * 132 blocks, each split a whole number of 64-key
    tiles."""
    assert fd.smem_bytes(5, 64, torch.bfloat16) == 51_200
    n, length = fd.split_plan(8, 5, 32768, 132, dtype=torch.bfloat16,
                              groups=5, dh=64)
    assert 8 * 5 * n <= 4 * 132 < 8 * 5 * (n + 1)
    assert length % 64 == 0


def test_flash_decode_shared_memory_fits_a_block():
    """bf16: one block per 16 query heads, so any G fits; float32: the
    SIMT block holds every head of the group, up to 64 at Dh 256."""
    for dh in range(1, fd.MAX_HEAD_DIM + 1):
        assert fd.head_dim_pad(dh) >= dh and fd.head_dim_pad(dh) % 16 == 0
        for g in (1, 5, 16, 17, 48, 1000):
            assert fd.smem_bytes(g, dh, torch.bfloat16) <= fd.BLOCK_SMEM
        for g in range(1, 65):
            assert fd.smem_bytes(g, dh, torch.float32) <= fd.BLOCK_SMEM


@pytest.mark.parametrize("tile", range(len(bm.SGEMM_TILES)))
def test_sgemm_tile_threads_own_every_output_once(tile):
    """Thread (tr, tc) owns rows TM*tr .. + TM-1 and columns 8tc .. 8tc+7
    of the block tile: together every output once; the 16-byte copies of
    a K step divide evenly among the threads."""
    b_m, b_n, t_m, threads, b_k = bm.SGEMM_TILES[tile]
    cols = b_n // 8
    owned = [(t_m * (tid // cols) + r, 8 * (tid % cols) + c)
             for tid in range(threads) for r in range(t_m) for c in range(8)]
    assert sorted(owned) == list(itertools.product(range(b_m), range(b_n)))
    assert (b_m * b_k // 4) % threads == 0
    assert (b_k * b_n // 4) % threads == 0


@pytest.mark.parametrize("tile", range(len(bm.SGEMM_TILES)))
def test_sgemm_grid_covers_the_product_with_no_gap(tile):
    b_m, b_n = bm.SGEMM_TILES[tile][:2]
    for b, n in itertools.product((1, 37, 128, 1024, 1025), (3, 64, 200,
                                                             1024)):
        gx, gy = bm.sgemm_grid(b, n, tile)
        assert gx * b_n >= n > (gx - 1) * b_n
        assert gy * b_m >= b > (gy - 1) * b_m


def test_the_chosen_tile_is_one_of_the_swept():
    assert 0 <= bm.SGEMM_TILE < len(bm.SGEMM_TILES)
    assert bm.sgemm_grid(1024, 1024) == bm.sgemm_grid(1024, 1024,
                                                      bm.SGEMM_TILE)


# -- ssd_chunk -------------------------------------------------------------


@pytest.mark.parametrize("q,n,p", [(1, 1, 1), (63, 16, 64), (64, 16, 64),
                                   (65, 128, 20), (256, 16, 64),
                                   (257, 128, 128), (256, 100, 64)])
def test_ssd_plan_covers_rows_keys_and_state_once(q, n, p):
    """The blocks of one (b, h): every y row once, each with every key
    tile up to its own (the causal triangle), and every N x P element of
    the new state once, every state block walking every key tile."""
    plan = sc.launch_plan(2, q, 3, n, p, torch.bfloat16)
    units = [sc.unit_work(u, q, n, p) for u in
             range(plan["y_blocks"] + plan["state_blocks"])]
    assert plan["blocks"] == len(units) * 2 * 3
    rows, state = [], []
    for w in units:
        if "y_rows" in w:
            rows += list(w["y_rows"])
            assert list(w["key_tiles"]) == list(range(w["y_rows"][0] // 64
                                                      + 1))
        else:
            state += [(r, c) for r in w["state_rows"] for c in
                      w["state_cols"]]
            assert list(w["key_tiles"]) == list(range(-(-q // 64)))
    assert sorted(rows) == list(range(q))
    assert sorted(state) == list(itertools.product(range(n), range(p)))
    # Heaviest first: the state blocks (every key tile), then y tiles in
    # decreasing order of the key tiles they walk.
    walks = [len(w["key_tiles"]) for w in units]
    assert walks == sorted(walks, reverse=True)


@pytest.mark.parametrize("geom", sorted(SMOKE.SSD_GEOMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_plan_fills_the_card_at_the_served_batch(geom, dtype):
    """B 2 at Q 256 (the forward's shape): at least one block per SM of
    the 132, and at least 500 at hymba's 50 heads."""
    h, n, p = SMOKE.SSD_GEOMS[geom]
    plan = sc.launch_plan(2, 256, h, n, p, dtype)
    assert plan["blocks"] >= 132
    if geom == "hymba":
        assert plan["blocks"] >= 500


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_shared_memory_fits_a_block(dtype):
    for n, p in itertools.product((1, 16, 64, 128), repeat=2):
        for q in (1, 64, 256, 257, 1024):
            smem = sc.smem_bytes(q, n, p, dtype)
            assert smem <= sc.BLOCK_SMEM, (n, p, q, smem)
            assert smem % 16 == 0
        assert sc.launch_plan(1, 256, 1, n, p, dtype)["col_tiles"] * 8 >= p



@pytest.mark.parametrize("b,ms", [(8, 0.011004179104477612),
                                  (2, 0.002751044776119403)])
def test_ssd_bound_at_the_rows_shape_is_the_bytes(b, ms):
    """At hymba's chunk with bf16 x, B and C the products, each counted at
    its type and terms (C B^T 1 x bf16, G x 3 x bf16, C S and the state
    2 x TF32: 7.2 us at B 8), take less than the operands' 36.9 MB at B 8
    (11.0 us), so the bytes bound the row."""
    q, h, n, p = 256, 50, 16, 64
    nbytes = (2 * 2 * b * q * h * p + 2 * 2 * b * q * h * n
              + 4 * 2 * b * q * h + 4 * 2 * b * h * n * p)
    assert SMOKE.ssd_bound(b, q, h, n, p, nbytes) == pytest.approx(
        (ms, "bytes"), rel=1e-12)
    assert SMOKE.ssd_bound(b, q, h, n, p, 0)[0] == pytest.approx(
        b / 8 * 7.2294e-3, rel=1e-4)

@pytest.mark.parametrize("b,d,c", [(1, 1, 1), (17, 13, 3), (256, 1024, 1024),
                                   (300, 129, 65), (64, 100, 130),
                                   (5, 257, 1025)])
@pytest.mark.parametrize("block_b", qu.BLOCK_B_CHOICES)
def test_qail_plan_tiles_and_scratch(b, d, c, block_b):
    """Column tiles of 64 and query tiles of block_b cover C and B; the
    int8 copies pad D to 128-byte slabs; the convert tiles (64 x 64)
    cover both copies; the scratch regions are 256-byte aligned, do not
    overlap and hold their contents."""
    pl = qu.plan(b, d, c, block_b)
    assert pl["n_ct"] * 64 >= c > (pl["n_ct"] - 1) * 64
    assert pl["n_rt"] * block_b >= b > (pl["n_rt"] - 1) * block_b
    assert pl["dp"] % 128 == 0 and pl["dp"] - 128 < d <= pl["dp"]
    assert pl["bp"] == pl["n_rt"] * block_b and pl["cp"] == pl["n_ct"] * 64
    kt = pl["dp"] // 64
    assert pl["n_am_tiles"] == kt * pl["cp"] // 64
    assert pl["n_conv"] - pl["n_am_tiles"] == kt * -(-pl["bp"] // 64)
    want = {"q8": pl["bp"] * pl["dp"], "am8": pl["cp"] * pl["dp"],
            "flags": 4 * pl["n_conv"], "counters": 4 * pl["n_rt"],
            "part_s": 8 * b * pl["n_ct"], "part_i": 8 * b * pl["n_ct"]}
    assert pl["sizes"] == want
    spans = sorted((pl["offsets"][k], pl["offsets"][k] + v)
                   for k, v in want.items())
    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
        assert lo % 256 == 0 and hi <= lo2
    assert spans[-1][1] <= pl["scratch_bytes"]
    assert pl["scratch_bytes"] % 256 == 0


# -- a rounding model of ssd_chunk's split products ------------------------

def _tf32(x):
    """float32 rounded to TF32 (10 fraction bits), to nearest, ties away
    from zero (cvt.rna.tf32.f32), on the bit patterns."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _prod3(eq, a, b):
    """einsum of a and b as the kernel forms it: hi = tf32(v), lo =
    tf32(v - hi), lo*hi' + hi*lo' + hi*hi' (each product exact in
    float32)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _bf16x3(g):
    """g as three bf16 terms, each the rounding of what the others leave."""
    terms = []
    for _ in range(3):
        t = g.to(torch.bfloat16).float()
        terms.append(t)
        g = g - t
    return terms


def _ssd_split_model(x, b, c, dt, da, state, exact_inputs):
    """ref.ssd_chunk with the kernel's products (float32 out): C B^T exact
    on bf16 inputs (exact_inputs), else three TF32 products; dt folded
    into the decay; G x as three bf16 terms of G against exact bf16 x, or
    three TF32 products; C S and the state update three TF32 products."""
    q = x.shape[1]
    cum = torch.cumsum(da, dim=1)
    total = cum[:, -1]
    if exact_inputs:
        cb = torch.einsum("bqhn,bkhn->bqkh", c, b)
    else:
        cb = _prod3("bqhn,bkhn->bqkh", c, b)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool))[None, :, :, None]
    g = torch.where(mask, cb * torch.exp(cum[:, :, None, :]
                                         - cum[:, None, :, :])
                    * dt[:, None, :, :], 0.0)
    if exact_inputs:
        y = sum(torch.einsum("bqkh,bkhp->bqhp", t, x)
                for t in reversed(_bf16x3(g)))
    else:
        y = _prod3("bqkh,bkhp->bqhp", g, x)
    y = y + _prod3("bqhn,bhnp->bqhp", c, state) * torch.exp(cum)[..., None]
    w = b * (torch.exp(total[:, None] - cum) * dt)[..., None]
    s_new = (state * torch.exp(total)[..., None, None]
             + _prod3("bqhn,bqhp->bhnp", w, x))
    return y, s_new


@pytest.mark.parametrize("geom", sorted(SMOKE.SSD_GEOMS))
@pytest.mark.parametrize("q", SMOKE.SSD_Q)
@pytest.mark.parametrize("route", ["float32", "bfloat16"])
def test_ssd_split_products_stay_inside_the_tolerance(geom, q, route):
    """chip_smoke.py's SSD geometries and chunk lengths with its inputs'
    distributions: the split products keep y and the new state within a
    quarter of the tolerance 1e-4 + 1e-4|x| of the plain float32 result
    (on bfloat16 inputs compared before the cast to bf16, which adds one
    bf16 ulp to the tolerance on the card)."""
    h, n, p = SMOKE.SSD_GEOMS[geom]
    rng = np.random.default_rng([16, h, n, q])
    nrm = rng.normal
    dt = np.abs(nrm(size=(2, q, h))).astype(np.float32) * 0.1
    x, b, c = (torch.tensor(nrm(size=(2, q, h, d)).astype(np.float32))
               for d in (p, n, n))
    if route == "bfloat16":  # bf16 values, held in float32
        x, b, c = (t.to(torch.bfloat16).float() for t in (x, b, c))
    da = torch.tensor(-dt * np.abs(nrm(size=(2, q, h))).astype(np.float32))
    dt, state = torch.tensor(dt), torch.tensor(
        nrm(size=(2, h, n, p)).astype(np.float32))
    y, s_new = _ssd_split_model(x, b, c, dt, da, state,
                                exact_inputs=route == "bfloat16")
    wy, ws = ref.ssd_chunk(x, b, c, dt, da, state)
    assert ((y - wy).abs() <= 0.25 * (1e-4 + 1e-4 * wy.abs())).all()
    assert ((s_new - ws).abs() <= 0.25 * (1e-4 + 1e-4 * ws.abs())).all()
