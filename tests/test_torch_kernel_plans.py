"""The pure-Python launch planning of the port's wrappers, on the CPU.

``flash_decode``'s split of S and shared-memory count, the block tiles
of the fp32 mainloop that ``binary_mvm`` and ``encode_pack`` share
(``csrc/sgemm_tile.cuh``), ``ssd_chunk``'s grid and shared memory,
``qail_update``'s tiles and scratch, a rounding model of the split
products ``ssd_chunk`` runs on the tensor cores, ``am_search_packed``'s
launch plans, models of its unpack-mode and popcount-mode (1-bit)
fragments, popcount mode's shared reads and split key fold,
``am_search_sparse``'s tile ring, shared memory and scratch choice, and
the launch plans, route tests and a model of the int8 routes'
arithmetic of ``am_search_imc``, ``am_search_multibit`` and
``am_search``. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import am_search as ams  # noqa: E402
from repro_torch.kernels import am_search_imc as asi  # noqa: E402
from repro_torch.kernels import am_search_multibit as asm  # noqa: E402
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import am_search_sparse as ass  # noqa: E402
from repro_torch.kernels import am_shortlist as asl  # noqa: E402
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


# -- am_search_packed ------------------------------------------------------

SMEM_LIMIT = 232448  # shared memory one block may opt into (H100)
H100_SMS = 132


@pytest.mark.parametrize("b,c", [(1, 1), (1, 127), (16, 128), (17, 129),
                                 (1023, 1000), (1024, 1024),
                                 (300, 100_000)])
@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_unpack_plan_tiles_cover_b_and_c(b, c, block_b):
    """Unpack mode: blocks of max(16, block_b) rows (whole m16 tiles) by
    128 columns cover B and C with no empty block; the scratch holds a
    uint64 key per query and a ticket word per query tile."""
    pl = asp.launch_plan(b, 128, c, block_b, "unpack", H100_SMS)
    rows, cols = pl["rows"], pl["cols"]
    assert rows == max(16, block_b) and rows % 16 == 0 and cols == 128
    gx, gy = pl["grid"]
    assert gx * rows >= b > (gx - 1) * rows
    assert gy * cols >= c > (gy - 1) * cols
    assert pl["scratch_bytes"] == 8 * b + 4 * gx


@pytest.mark.parametrize("block_b,smem", [(4, 22280), (8, 22280),
                                          (16, 22280), (32, 26120)])
def test_unpack_plan_shared_memory_is_the_kernels_static_smem(block_b, smem):
    """sizeof(Smem<MI>) in csrc/am_search_packed.cu: a 4-stage ring of
    32-byte k slabs (query rows 48 bytes apart, 32 AM byte rows of 144),
    the four warps' uint64 keys and int shares of each row's popcount,
    and the last-block flag, rounded to 8; any D, well under a block's
    limit."""
    for dp in (1, 13, 128, 1000):
        pl = asp.launch_plan(64, dp, 300, block_b, "unpack", H100_SMS)
        assert pl["smem"] == smem
    assert smem <= SMEM_LIMIT // 8


def test_unpack_plan_fills_the_card_at_the_main_shape():
    """B = C = 1024: at least a block per SM of the 132 at every block_b,
    and at the default (16-row blocks) about four (512 blocks)."""
    for block_b in asp.BLOCK_B_CHOICES:
        gx, gy = asp.launch_plan(1024, 128, 1024, block_b, "unpack",
                                 H100_SMS)["grid"]
        assert gx * gy >= 132
    gx, gy = asp.launch_plan(1024, 128, 1024, asp.DEFAULT_BLOCK_B,
                             "unpack", H100_SMS)["grid"]
    assert (gx, gy) == (64, 8)


@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_popcount_plan_tiles_cover_b_and_c_with_its_ring_and_scratch(block_b):
    """Popcount mode: blocks of max(16, block_b) rows (whole m16 tiles of
    the 1-bit mma) by 8 to 128 columns (min(4, cols / 8) warps) cover B
    and C with no empty block; the dynamic shared memory is the 4-stage
    ring of 32-byte k slabs (query rows 48 bytes apart, then 32 AM byte
    rows of max(cols + 16, 32) bytes) and the warps' uint64 keys of each
    row; the scratch a uint64 key per query and a ticket word per query
    tile, as csrc/am_search_packed.cu's launcher checks."""
    for b, dp, c in ((1, 13, 3), (1024, 128, 1024), (5, 1000, 100_000),
                     (32, 128, 1024), (1023, 125, 129)):
        pl = asp.launch_plan(b, dp, c, block_b, "popcount", H100_SMS)
        rows, cols, warps = pl["rows"], pl["cols"], pl["warps"]
        assert rows == max(16, block_b) and rows % 16 == 0
        assert cols in (8, 16, 32, 64, 128) and warps == min(4, cols // 8)
        assert (cols // 8) % warps == 0 and cols // 8 // warps in (1, 2, 4)
        gx, gy = pl["grid"]
        assert gx * rows >= b > (gx - 1) * rows
        assert gy * cols >= c > (gy - 1) * cols
        assert pl["smem"] == (4 * (rows * 48 + 32 * max(cols + 16, 32))
                              + 8 * warps * rows)
        assert pl["scratch_bytes"] == 8 * b + 4 * gx


@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
@pytest.mark.parametrize("d", [1024, 4096])
def test_popcount_shared_memory_fits_a_block_at_any_d(block_b, d):
    """The ring holds 32-byte slabs, so its shared memory does not grow
    with D: at most 25,600 bytes (two m16 tiles, 128 columns), under a
    block's default 48 KB at D = 1024 and 4096 alike."""
    for b in (1, 32, 1024):
        pl = asp.launch_plan(b, d // 8, 1024, block_b, "popcount",
                             H100_SMS)
        assert pl["smem"] <= 4 * (32 * 48 + 32 * 144) + 8 * 4 * 32 == 25600
        assert pl["smem"] <= 48 * 1024 <= SMEM_LIMIT
    pl = asp.launch_plan(1024, d // 8, 1024, block_b, "popcount", H100_SMS)
    assert pl == asp.launch_plan(1024, 128, 1024, block_b, "popcount",
                                 H100_SMS)


def test_popcount_plan_fills_the_card_at_b_1024_and_b_32():
    """B = C = 1024: 128-column splits, 512 blocks of 4 warps (256 at
    block_b 32). A served request, B = 32: 8-column splits, 256 blocks
    of one warp (128 at block_b 32, whose one query tile leaves 8 columns
    the narrowest split). The first version ran 1 to 8 blocks at B = 32
    and 32 to 256 at B = 1024. Elsewhere the widest split that gives a
    block per SM is taken."""
    for block_b in asp.BLOCK_B_CHOICES:
        pl = asp.launch_plan(1024, 128, 1024, block_b, "popcount", H100_SMS)
        gx, gy = pl["grid"]
        assert pl["cols"] == 128 and pl["warps"] == 4
        assert gx * gy == (256 if block_b == 32 else 512)
        pl = asp.launch_plan(32, 128, 1024, block_b, "popcount", H100_SMS)
        gx, gy = pl["grid"]
        assert pl["cols"] == 8 and pl["warps"] == 1
        assert gx * gy == (128 if block_b == 32 else 256)
        assert gx * gy >= H100_SMS or block_b == 32
    for b, c in ((256, 1024), (64, 300), (1, 100_000), (7, 9)):
        for rows in (16, 32):
            cols = asp.popcount_cols(b, c, rows, H100_SMS)
            blocks = {k: -(-b // rows) * -(-c // k)
                      for k in (128, 64, 32, 16, 8)}
            assert cols == 8 or blocks[cols] >= H100_SMS
            assert cols == 128 or blocks[2 * cols] < H100_SMS


@pytest.mark.parametrize("sms", [1, 78, 114, 132, 144, 10_000])
def test_popcount_plan_follows_the_devices_sm_count(sms):
    """The column split is picked for the SM count the plan is made for
    (the launcher refuses a plan made for another device): the widest
    split whose grid has a block per SM, 128 columns on a one-SM device,
    8 where no split fills the device; unpack mode's grid does not depend
    on it."""
    for b, c in ((32, 1024), (1024, 1024), (1, 100_000), (300, 129)):
        for block_b in asp.BLOCK_B_CHOICES:
            pl = asp.launch_plan(b, 128, c, block_b, "popcount", sms)
            rows, cols = pl["rows"], pl["cols"]
            assert pl["sms"] == sms
            tiles = -(-b // rows)
            assert cols == 8 or tiles * -(-c // cols) >= sms
            assert cols == 128 or tiles * -(-c // (2 * cols)) < sms
            assert pl["grid"] == (tiles, -(-c // cols))
            un = asp.launch_plan(b, 128, c, block_b, "unpack", sms)
            assert un == {**asp.launch_plan(b, 128, c, block_b, "unpack",
                                            H100_SMS), "sms": sms}
    assert asp.launch_plan(32, 128, 1024, 8, "popcount", 1)["cols"] == 128
    assert asp.launch_plan(32, 128, 1024, 8, "popcount", 10_000)["cols"] == 8


def _popc(x):
    return np.unpackbits(x[..., None].view(np.uint8), axis=-1).sum(
        axis=-1).astype(np.int64)


@pytest.mark.parametrize("cols", [8, 16, 64, 128])
@pytest.mark.parametrize("d", [8, 100, 257, 1024])
def test_popcount_b1_fragments_give_the_hamming_distance(cols, d):
    """A model of popcount::search on one block: the ring stages 32-byte
    slabs zero-padded past Dp (AM byte row 4w + k at stage row 8k + w);
    lane (gid, tig) takes A words tig and 4 + tig of rows gid and gid + 8
    (ldmatrix of the query rows) and gathers B words tig and 4 + tig of
    column gid, byte k from row 8k + w; the m16n8k256 AND-popcount sums
    over (lane, word) pairs, and P_q + P_a - 2 * that sum, with the
    popcounts summed over the four lanes, is the plain Hamming distance."""
    rng = np.random.default_rng([20, cols, d])
    dp, rows = -(-d // 8), 16
    q = rng.integers(0, 256, (rows, dp), dtype=np.uint8)
    am_t = rng.integers(0, 256, (dp, cols), dtype=np.uint8)
    # pack_rows leaves the bits past d at 0 in both operands
    tail = np.uint8((1 << (d % 8)) - 1) if d % 8 else np.uint8(255)
    q[:, -1] &= tail
    am_t[-1] &= tail
    acc = np.zeros((rows, cols), np.int64)
    pq = np.zeros(rows, np.int64)
    pa = np.zeros(cols, np.int64)
    for t in range(-(-dp // 32)):
        qs = np.zeros((rows, 48), np.uint8)
        part = q[:, 32 * t:32 * t + 32]
        qs[:, :part.shape[1]] = part
        ast = np.zeros((32, max(cols + 16, 32)), np.uint8)
        for r in range(32):
            if 32 * t + r < dp:
                ast[(r & 3) * 8 + (r >> 2), :cols] = am_t[32 * t + r]
        qw = qs[:, :32].copy().view("<u4")   # (rows, 8): words of a row
        for tig in range(4):
            a = qw[:, [tig, 4 + tig]]            # a0/a2 (rows gid), a1/a3
            pq += _popc(a).sum(1)
            for n0 in range(0, cols, 8):
                for gid in range(8):
                    c = n0 + gid
                    b = np.array([sum(int(ast[k * 8 + w, c]) << (8 * k)
                                      for k in range(4))
                                  for w in (tig, 4 + tig)], dtype=np.uint32)
                    pa[c] += _popc(b).sum()
                    acc[:, c] += _popc(a & b[None, :]).sum(1)
    ham = pq[:, None] + pa[None, :] - 2 * acc
    bits_q = np.unpackbits(q, axis=1, bitorder="little")
    bits_a = np.unpackbits(am_t.T, axis=1, bitorder="little")
    want = (bits_q[:, None, :] != bits_a[None, :, :]).sum(-1)
    assert np.array_equal(ham, want)


@pytest.mark.parametrize("cols", [8, 16, 32, 64, 128])
def test_popcount_shared_reads_are_conflict_free(cols):
    """Each shared load of a warp touches each bank at one address: the B
    gather of lane (gid, tig), byte k of word 4h + tig of its n8 tile's
    column gid, at stage row 8k + 4h + tig of max(cols + 16, 32) bytes
    (a multiple of 16, for cp.async); and the ldmatrix rows of the query
    ring, 48 bytes apart, in 8 distinct 16-byte bank groups."""
    ld = max(cols + 16, 32)
    assert ld % 16 == 0
    lanes = np.arange(32)
    gid, tig = lanes >> 2, lanes & 3
    for n0 in range(0, cols, 8):
        for k in range(4):
            for h in range(2):
                byte = (k * 8 + 4 * h + tig) * ld + n0 + gid
                banks = {}
                for a in byte // 4:
                    banks.setdefault(a % 32, set()).add(a)
                assert all(len(v) == 1 for v in banks.values())
    groups = {(r * 48 // 16) % 8 for r in range(8)}
    assert len(groups) == 8


def _split_fold(ham, cols):
    """The popcount fold: each split's least key (hamming << 32) | idx per
    row, then the least over splits in a shuffled block order (atomicMin
    is order-free); idx = key & 0xffffffff."""
    b, c = ham.shape
    keys = (ham.astype(np.uint64) << np.uint64(32)) | np.arange(
        c, dtype=np.uint64)
    split_min = [keys[:, c0:c0 + cols].min(1) for c0 in range(0, c, cols)]
    order = np.random.default_rng(c).permutation(len(split_min))
    best = np.full(b, np.iinfo(np.uint64).max, dtype=np.uint64)
    for i in order:
        best = np.minimum(best, split_min[i])
    return (best & np.uint64(0xffffffff)).astype(np.int32), (
        best >> np.uint64(32)).astype(np.int64)


@pytest.mark.parametrize("cols", [8, 16, 32, 64, 128])
def test_split_key_fold_is_first_wins_across_splits(cols):
    """Exact copies of each query (the tied maximum, Hamming 0) planted in
    two different column splits, the lower copy in the earlier split for
    even rows and in the later one for odd rows: the 64-bit key fold gives
    the first maximal column, as the plain version's argmax does, in any
    block order."""
    rng = np.random.default_rng([21, cols])
    d, b = 200, 6
    c = 8 * cols + 3
    qb = rng.integers(0, 2, (b, d))
    ab = rng.integers(0, 2, (c, d))
    early, late = 2 * cols + 5, 5 * cols + 1   # splits 2 and 5
    want = []
    for r in range(b):
        ab[early + r] = ab[late + r] = qb[r]
        if r % 2:
            ab[early - cols + r] = qb[r]       # also in split 1: it wins
            want.append(early - cols + r)
        else:
            want.append(early + r)
    ham = (qb[:, None, :] != ab[None, :, :]).sum(-1)
    idx, hbest = _split_fold(ham, cols)
    sims = torch.as_tensor(d - 2 * ham, dtype=torch.float32)
    w_sim, w_idx = sims.max(dim=-1)
    assert np.array_equal(idx, w_idx.numpy())
    assert np.array_equal(d - 2 * hbest, w_sim.numpy())
    assert np.array_equal(idx, want) and (hbest == 0).all()


def _spread(x):
    """csrc/am_search_packed.cu spread(): bits 0-3 of x -> bytes 0-3."""
    return (x * np.uint32(0x00204081)) & np.uint32(0x01010101)


def _bytes(word):
    """uint32 words -> (..., 4) int8, byte 0 first."""
    return word[..., None].view(np.uint8).reshape(*word.shape, 4).view(
        np.int8)


@pytest.mark.parametrize("d", [1, 8, 31, 100, 257, 1024])
def test_unpack_fragments_give_the_hamming_distance(d):
    """A model of the unpack kernel's fragments: per 32-dim step, lane tig's
    A registers hold byte tig of the query's packed word as ±1 (low nibble
    a[0], high a[2]; 0 past n_dims) and its B registers the same byte of
    the column's word as {0, 1}. The mma's sum over every (step, lane, byte)
    product, taken from the register bytes, is P - hamming: with P the
    query's valid 1-bits, hamming = P - acc."""
    rng = np.random.default_rng([18, d])
    dp = -(-d // 8)
    x = rng.integers(0, 2, size=(40, d)).astype(np.uint8)
    y = rng.integers(0, 2, size=(40, d)).astype(np.uint8)
    qp = np.packbits(x, axis=1, bitorder="little")
    ap = np.packbits(y, axis=1, bitorder="little")
    n_kw = -(-d // 32)
    pad = 4 * n_kw - dp
    qw = np.pad(qp, ((0, 0), (0, pad))).view("<u4")  # (40, n_kw)
    aw = np.pad(ap, ((0, 0), (0, pad))).view("<u4")
    acc = np.zeros(40, dtype=np.int64)
    for kw in range(n_kw):
        for tig in range(4):
            xb = (qw[:, kw] >> np.uint32(8 * tig)) & np.uint32(0xFF)
            yb = (aw[:, kw] >> np.uint32(8 * tig)) & np.uint32(0xFF)
            nv = d - 32 * kw - 8 * tig
            m = np.uint32(0xFF if nv >= 8 else 0 if nv <= 0 else
                          (1 << nv) - 1)
            for sh, mn in ((0, m & 15), (4, m >> 4)):
                a = ~(_spread((xb >> np.uint32(sh)) & np.uint32(15))
                      * np.uint32(0xFE))
                a &= _spread(np.uint32(mn)) * np.uint32(0xFF)
                bb = _spread((yb >> np.uint32(sh)) & np.uint32(15))
                assert set(np.unique(_bytes(a))) <= {-1, 0, 1}
                assert set(np.unique(_bytes(bb))) <= {0, 1}
                acc += (_bytes(a).astype(np.int64)
                        * _bytes(bb).astype(np.int64)).sum(axis=-1)
    pop = x.sum(axis=1)
    ham = (x != y).sum(axis=1)
    assert np.array_equal(pop - acc, ham)


# -- am_search_packed, popcount mode's sweep route ----------------------------

TUNER_GEOMETRIES = ((128, 128), (256, 256), (1024, 1024))  # (D, C)


@pytest.mark.parametrize("b,d,c,route", [
    (4096, 1024, 100_000, "sweep"), (1024, 1024, 100_000, "sweep"),
    (256, 1024, 100_000, "sweep"), (128, 1024, 100_000, "sweep"),
    (300, 100, 50_000, "sweep"), (4096, 1024, 1024, "sweep"),
    (2048, 1024, 1024, "tile"), (1024, 1024, 1024, "tile"),
    (300, 1024, 5000, "tile"), (1024, 1024, 2047, "tile"),
    (32, 1024, 1024, "tile"), (1, 1024, 100_000, "tile"),
    (127, 1024, 100_000, "tile"), (256, 1024, 1024, "tile"),
    (128, 1024, 2048, "tile"), (128, 1024, 16_384, "tile"),
    (4096, 1032, 100_000, "tile"), (4096, 8192, 100_000, "tile")])
def test_popcount_route_follows_the_shape(b, d, c, route):
    """The route comes from (B, Dp, C, sms) alone, at every block_b: the
    sweep at the benchmark's B 4,096 x C 100,000 and wherever 128-row
    query tiles of D <= 1024 meet 2^21 (row, column) pairs or more with a
    grid of a quarter of the SMs (B 4,096 x C 1,024 among them); the tile
    route at B = C = 1024, a served B = 32, B = 1, B 256 x C 1,024,
    grids under a quarter of the SMs (B 2,048 x C 1,024: 16 x 2 blocks;
    B 128 x C 16,384: 1 x 32) and D > 1024."""
    for block_b in asp.BLOCK_B_CHOICES:
        pl = asp.launch_plan(b, -(-d // 8), c, block_b, "popcount",
                             H100_SMS)
        assert pl["route"] == route
        assert asp.popcount_route(b, -(-d // 8), c, H100_SMS) == route
        if route == "tile":
            assert pl == asp.tile_plan(b, -(-d // 8), c, block_b, H100_SMS)
        else:
            assert pl == asp.sweep_plan(b, -(-d // 8), c, H100_SMS)


@pytest.mark.parametrize("d,c", TUNER_GEOMETRIES)
def test_popcount_tuner_geometries_stay_on_the_tile_route(d, c):
    """The autotuner's three geometries, at the batches it times, keep
    the tile route (``block_b`` keeps its meaning there)."""
    from repro_torch.kernels import autotune
    assert {"D": d, "C": c} in autotune.DEFAULT_GEOMETRIES[
        "am_search_packed"]
    for b in autotune.KERNELS["am_search_packed"].batches:
        for block_b in asp.BLOCK_B_CHOICES:
            assert asp.launch_plan(b, d // 8, c, block_b, "popcount",
                                   H100_SMS)["route"] == "tile"


def _group_tiles(c, groups):
    """search_sweep's column groups: group g walks column tiles
    [g ct // G, (g + 1) ct // G)."""
    ct = -(-c // 128)
    return [(g * ct // groups, (g + 1) * ct // groups)
            for g in range(groups)]


@pytest.mark.parametrize("b,c", [(128, 2048), (129, 100_000),
                                 (256, 100_000), (1023, 50_001),
                                 (4096, 100_000), (4097, 99_999),
                                 (20_000, 100_000), (300, 1_100_000)])
@pytest.mark.parametrize("dp", [13, 63, 98, 128])
def test_sweep_grid_covers_b_and_groups_partition_c_in_order(b, c, dp):
    """Sweep plan: query tiles of 128 rows cover B; the column groups are
    contiguous runs of 128-column tiles, in order, none empty, that
    together cover C once; each walks 4 tiles at least (where C has them)
    and at most 8,191, so a key's column fits its 20 bits; the grid is
    one wave of the SMs where the query tiles leave room; the scratch is
    a uint64 key per query and a ticket word per query tile."""
    pl = asp.sweep_plan(b, dp, c, H100_SMS)
    tiles, groups = pl["grid"]
    assert pl["rows"] == 128 and pl["cols"] == 128 and pl["warps"] == 8
    assert tiles * 128 >= b > (tiles - 1) * 128
    assert pl["groups"] == groups == asp.sweep_groups(b, c, H100_SMS)
    ct = -(-c // 128)
    runs = _group_tiles(c, groups)
    assert runs[0][0] == 0 and runs[-1][1] == ct
    assert all(lo < hi for lo, hi in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(groups - 1))
    assert min(hi - lo for lo, hi in runs) >= min(4, ct)
    assert max(hi - lo for lo, hi in runs) * 128 < 1 << 20
    assert tiles * groups <= max(H100_SMS, tiles * -(-ct // 8191))
    assert pl["scratch_bytes"] == 8 * b + 4 * tiles


@pytest.mark.parametrize("dp", [1, 13, 32, 33, 64, 98, 128])
def test_sweep_shared_memory_fits_an_h100_block(dp):
    """The query tile (128 rows of 32 ks + 16 bytes), a 4-stage ring of
    whole column tiles (32 ks rows of 144 bytes) and the four column
    warps' uint32 keys of each row, ks = ceil(Dp / 32): 94,208 bytes at
    D = 1024, under the 227 KB (232,448 bytes) a block may opt into; one
    block of 8 warps per SM."""
    ks = -(-dp // 32)
    pl = asp.sweep_plan(4096, dp, 100_000, H100_SMS)
    assert pl["smem"] == 128 * (32 * ks + 16) + 4 * 32 * ks * 144 + 2048
    assert pl["smem"] <= SMEM_LIMIT
    assert asp.sweep_plan(4096, 128, 100_000, H100_SMS)["smem"] == 94208


@pytest.mark.parametrize("sms", [1, 78, 114, 132, 144, 10_000])
def test_sweep_plan_follows_the_devices_sm_count(sms):
    """The column groups are picked for the SM count the plan is made for:
    sms // query tiles, at least one and at most a 4-tile walk each; the
    route needs a quarter of the device's SMs in the grid."""
    for b, c in ((4096, 100_000), (256, 100_000), (1024, 100_000),
                 (128, 20_000)):
        pl = asp.sweep_plan(b, 128, c, sms)
        tiles, ct = -(-b // 128), -(-c // 128)
        assert pl["sms"] == sms
        assert pl["groups"] == max(1, min(sms // tiles, ct // 4))
        blocks = tiles * pl["groups"]
        route = asp.popcount_route(b, 128, c, sms)
        assert route == ("sweep" if 4 * blocks >= sms else "tile")
    assert asp.sweep_plan(4096, 128, 100_000, 132)["grid"] == (32, 4)
    assert asp.sweep_plan(256, 128, 100_000, 132)["grid"] == (2, 66)


def _prmt(x, y, sel):
    """__byte_perm(x, y, sel): byte j of the result is byte sel[j] of the
    eight bytes of y:x (x bytes 0-3)."""
    src = np.stack([(x >> np.uint32(8 * i)) & np.uint32(0xff)
                    for i in range(4)]
                   + [(y >> np.uint32(8 * i)) & np.uint32(0xff)
                      for i in range(4)])
    out = np.zeros_like(x)
    for j in range(4):
        out |= src[(sel >> (4 * j)) & 7] << np.uint32(8 * j)
    return out


def _words(b4):
    """(32, 4) bytes -> (32,) little-endian uint32."""
    return np.ascontiguousarray(b4.astype(np.uint8)).view("<u4")[:, 0]


def _mma_b1(a, b):
    """mma.sync.m16n8k256 .and.popc on the lanes' fragments: A (16 rows x
    8 words) from a[0..3], B (8 words x 8 columns) from b[0..1]; returns
    the four accumulator entries of each lane."""
    lanes = np.arange(32)
    gid, tig = lanes >> 2, lanes & 3
    am = np.zeros((16, 8), np.uint32)
    bm = np.zeros((8, 8), np.uint32)
    am[gid, tig], am[gid + 8, tig] = a[0], a[1]
    am[gid, 4 + tig], am[gid + 8, 4 + tig] = a[2], a[3]
    bm[tig, gid], bm[4 + tig, gid] = b[0], b[1]
    dm = _popc(am[:, :, None] & bm[None, :, :]).sum(1)
    return [dm[gid, 2 * tig], dm[gid, 2 * tig + 1], dm[gid + 8, 2 * tig],
            dm[gid + 8, 2 * tig + 1]]


def _sweep_block(q, am_t, b0, t0, n_t):
    """A model of one search_sweep block, lane by lane: the query tile
    (rows b0 ..) and the A fragments by ldmatrix, each column tile of the
    group (tiles t0 ..) staged at sweep_row, the B words by ldmatrix
    .trans and two byte permutes, P_a from an all-ones A, the 32-bit keys
    with a three-way min, then the four lanes, the four column warps and
    the 64-bit key of each row. Returns {row: (hamming, idx)}."""
    b, dp = q.shape
    c = am_t.shape[1]
    ks = -(-dp // 32)
    qs_ld, astr = 32 * ks + 16, 144
    qt = np.zeros((128, qs_ld), np.uint8)
    n = max(0, min(128, b - b0))
    qt[:n, :dp] = q[b0:b0 + n]
    lanes = np.arange(32)
    gid, tig = lanes >> 2, lanes & 3
    u = np.uint32
    red = np.full((4, 128), 0xffffffff, np.uint32)
    col0 = 128 * t0
    rows_of = {}
    for warp in range(8):
        wm, wn = warp >> 2, warp & 3
        a = {}
        for mi in range(4):
            for s in range(ks):
                base = 64 * wm + 16 * mi
                regs = []
                for m in range(4):  # ldmatrix .x4: lanes 8m .. 8m + 7
                    r = base + 8 * (m & 1) + gid
                    cb = 32 * s + 16 * (m >> 1) + 4 * tig
                    regs.append(_words(np.stack(
                        [qt[r, cb + i] for i in range(4)], 1)))
                a[mi, s] = regs
        best = np.full((4, 2, 32), 0xffffffff, np.uint32)
        for t in range(n_t):
            stage = np.zeros((32 * ks, astr), np.uint8)
            c_t = col0 + 128 * t
            for kb in range(min(dp, 32 * ks)):
                row = (kb & ~31) + int(_sweep_row(kb & 31))
                part = am_t[kb, c_t:c_t + 128]
                stage[row, :part.shape[0]] = part
            acc = {}
            pa = {}
            for s in range(ks):
                bq = {}
                for p in range(2):
                    regs = []
                    for m in range(4):  # .trans: lane l gives row 32 s + l
                        mat = stage[32 * s + 8 * m:32 * s + 8 * m + 8,
                                    32 * wn + 16 * p:32 * wn + 16 * p + 16]
                        regs.append(_words(np.stack(
                            [mat[2 * tig, 2 * gid], mat[2 * tig, 2 * gid + 1],
                             mat[2 * tig + 1, 2 * gid],
                             mat[2 * tig + 1, 2 * gid + 1]], 1)))
                    bq[2 * p] = (_prmt(regs[0], regs[1], 0x6420),
                                 _prmt(regs[2], regs[3], 0x6420))
                    bq[2 * p + 1] = (_prmt(regs[0], regs[1], 0x7531),
                                     _prmt(regs[2], regs[3], 0x7531))
                ones = [np.full(32, 0xffffffff, np.uint32)] * 4
                for ni in range(4):
                    d1 = _mma_b1(ones, bq[ni])
                    pa[ni] = [x + pa.get(ni, [0] * 4)[i]
                              for i, x in enumerate(d1)]
                    for mi in range(4):
                        d2 = _mma_b1(a[mi, s], bq[ni])
                        acc[mi, ni] = [x + acc.get((mi, ni), [0] * 4)[i]
                                       for i, x in enumerate(d2)]
            kt = u((1024 << 20) + 128 * t + 32 * wn) + (4 * tig).astype(u)
            cl = c_t + 32 * wn + 4 * tig
            kc = {}
            for ni in range(4):
                for j in range(2):
                    off = 16 * (ni >> 1) + 2 * j + (ni & 1)
                    k = (pa[ni][j].astype(u) << u(20)) + kt + u(off)
                    kc[ni, j] = np.where(cl + off >= c, u(0xffffffff), k)
            for mi in range(4):
                for ni in range(4):
                    for h in range(2):
                        k0 = kc[ni, 0] - (acc[mi, ni][2 * h].astype(u) << u(21))
                        k1 = kc[ni, 1] - (acc[mi, ni][2 * h + 1].astype(u)
                                          << u(21))
                        best[mi, h] = np.minimum(best[mi, h],
                                                 np.minimum(k0, k1))
        for mi in range(4):
            for h in range(2):
                v = best[mi, h]
                v = np.minimum(v, v[lanes ^ 1])
                v = np.minimum(v, v[lanes ^ 2])
                for g in range(8):
                    red[wn, 64 * wm + 16 * mi + 8 * h + g] = v[4 * g]
    for r in range(n):
        k = int(red[:, r].min())
        pq = int(_popc(qt[r]).sum())
        rows_of[b0 + r] = (pq + (k >> 20) - 1024, col0 + (k & 0xfffff))
    return rows_of


def _sweep_row(r):
    """b1_slab.cuh sweep_row: slab byte row 16 h + 4 a + 2 b + c at row
    16 h + 8 b + 2 a + c."""
    return (r & 16) | ((r >> 1) & 1) << 3 | ((r >> 2) & 3) << 1 | (r & 1)


def test_sweep_rows_put_each_lanes_k_bytes_in_order():
    """sweep_row is a permutation of a slab's 32 byte rows such that an
    ldmatrix .x4 .trans of rows 0-31 gives lane tig the k bytes 4 tig +
    (0, 1), (2, 3), 16 + 4 tig + (0, 1), (2, 3) from its four matrices'
    rows 2 tig, 2 tig + 1; and 8 consecutive rows of 144 bytes lie in 8
    distinct 16-byte bank groups."""
    perm = [_sweep_row(r) for r in range(32)]
    assert sorted(perm) == list(range(32))
    inv = {p: r for r, p in enumerate(perm)}
    for tig in range(4):
        for m in range(4):
            got = [inv[8 * m + 2 * tig], inv[8 * m + 2 * tig + 1]]
            want = [16 * (m >> 1) + 4 * tig + 2 * (m & 1) + i
                    for i in range(2)]
            assert got == want
    assert len({(r * 144 // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("d", [100, 500, 1024])
def test_sweep_block_model_gives_the_first_wins_winner(d):
    """The model of one search_sweep block (``_sweep_block``) over a group
    of two column tiles that starts at the AM's second tile and ends
    ragged (C 328), for a ragged query tile (B 100): every row's
    (hamming, idx) is the plain version's over the group's columns, with
    exact copies planted inside one lane's walk (tiles 0 and 1, and two n8
    tiles of one tile), across column warps and across the two tiles."""
    rng = np.random.default_rng([33, d])
    dp, b, c = -(-d // 8), 100, 328
    tail = np.uint8((1 << (d % 8)) - 1) if d % 8 else np.uint8(255)
    q = rng.integers(0, 256, (b, dp), dtype=np.uint8)
    am_t = rng.integers(0, 256, (dp, c), dtype=np.uint8)
    q[:, -1] &= tail
    am_t[-1] &= tail
    g0 = 128   # the group's first column
    plant = {0: (g0 + 128 + 5, g0 + 5),            # one lane, two tiles
             1: (g0 + 40, g0 + 10),                # column warps 1 and 0
             2: (g0 + 17, g0 + 16),                # one lane, n8 tiles 1, 0
             3: (g0 + 199, g0 + 130, g0 + 131),    # the ragged tile
             4: (c - 1, g0 + 127)}                 # the last column
    for r, cols in plant.items():
        for col in cols:
            am_t[:, col] = q[r]
    got = _sweep_block(q, am_t, 0, 1, 2)
    bits_q = np.unpackbits(q, axis=1, bitorder="little")
    bits_a = np.unpackbits(am_t[:, g0:].T, axis=1, bitorder="little")
    ham = (bits_q[:, None, :] != bits_a[None, :, :]).sum(-1)
    for r in range(b):
        assert got[r] == (int(ham[r].min()), g0 + int(ham[r].argmin()))
    for r, cols in plant.items():
        assert got[r] == (0, min(cols))


# -- am_search_sparse ------------------------------------------------------

@pytest.mark.parametrize("dp,rows,chunks", [(1, 4, 1), (13, 16, 1),
                                            (125, 128, 1), (128, 128, 1),
                                            (138, 128, 2), (256, 128, 2),
                                            (1000, 128, 8)])
def test_sparse_plan_chunks_cover_d(dp, rows, chunks):
    """A ring stage holds Dp rounded up to 4 rows, at most 128; a longer
    tile is read in chunks (the last zero-filled past Dp)."""
    pl = ass.launch_plan(7, dp, 3 * 128)
    assert pl["chunk_rows"] == rows and pl["stages"] == 3 and pl["grid"] == 7
    assert rows % 4 == 0 and -(-dp // rows) == chunks
    assert (chunks - 1) * rows < dp <= chunks * rows


def test_sparse_plan_at_the_huge_label_shape():
    """B 256, D 1024, S 8 x max_tiles 3 (3,072 slots) and S 16: the keys
    stay in shared memory beside the 49.5 KB ring; 75,520 bytes at S 8
    (the ring of 3 x (16 KB of rows + 128 ids), 24 KB of keys, 128 query
    words, 24 tile words, 8 warp words)."""
    pl = ass.launch_plan(256, 128, 8 * 3 * 128)
    assert pl["keys_in_smem"] and pl["chunk_rows"] == 128
    assert pl["smem"] == 3 * (128 + 4) * 128 + 8 * 3072 + 4 * (32 + 24 + 8)
    assert pl["smem"] == 75_520
    pl16 = ass.launch_plan(256, 128, 16 * 3 * 128)
    assert pl16["keys_in_smem"] and pl16["smem"] <= SMEM_LIMIT // 2


@pytest.mark.parametrize("dp", [1, 13, 128, 138, 1000])
def test_sparse_plan_moves_keys_to_scratch_when_they_do_not_fit(dp):
    """The keys stay in shared memory exactly while they and the ring fit
    the 8 * SMEM_SLOTS bytes of am_shortlist's rule; past it they go to
    the global scratch and the block's shared memory no longer grows with
    them. Every plan fits a block up to 100,000 slot tiles' words."""
    ring = 3 * (min(-(-dp // 4) * 4, 128) + 4) * 128
    last = (8 * asl.SMEM_SLOTS - ring) // 8 // 128 * 128
    assert ass.launch_plan(1, dp, last)["keys_in_smem"]
    big = ass.launch_plan(1, dp, last + 128)
    assert not big["keys_in_smem"]
    assert big["smem"] < ass.launch_plan(1, dp, last)["smem"]
    for slots in (128, last, last + 128, 4096 * 128, 40_000 * 128):
        assert ass.launch_plan(1, dp, slots)["smem"] <= SMEM_LIMIT
    # am_shortlist keeps its rule: keys in shared memory up to SMEM_SLOTS.
    assert asl.keys_fit(asl.SMEM_SLOTS) and not asl.keys_fit(
        asl.SMEM_SLOTS + 1)


def test_sparse_plain_reads_out_of_range_entries_as_the_null_tile():
    """expand_shortlist_tiles: a shortlist entry outside [0, G), a tile
    past tile_count and a tile outside the slab all point at the null
    tile, as the kernel reads them; an all-null shortlist returns only
    exhausted slots."""
    ts = torch.tensor([0, 1, 5], dtype=torch.int32)
    tc = torch.tensor([1, 2, 2], dtype=torch.int32)
    short = torch.tensor([[-1, 3, 1], [2, 0, 7]], dtype=torch.int32)
    tiles = ass.expand_shortlist_tiles(short, ts, tc, max_tiles=2,
                                       null_tile=5)
    assert tiles.tolist() == [[5, 5, 5, 5, 1, 2], [5, 5, 0, 5, 5, 5]]
    dp, ntiles = 2, 6
    slab = torch.randint(0, 256, (dp, ntiles * 128), dtype=torch.uint8)
    ids = torch.arange(ntiles * 128, dtype=torch.int32)
    ids[-128:] = -1
    q = torch.randint(0, 256, (2, dp), dtype=torch.uint8)
    nulls = torch.tensor([[-1, 3], [9, -7]], dtype=torch.int32)
    idx, sim = ass.am_search_sparse(q, slab, ids, nulls, ts, tc, n_dims=16,
                                    k=3, max_tiles=2)
    assert (idx == -1).all() and (sim == ref.NEG).all()


# -- am_search_imc and am_search_multibit -------------------------------------

SMEM_PER_SM = 233472  # shared memory of an H100 SM; 1 KB of it per block
ADC_PLANS = {"imc": asi.launch_plan, "multibit": asm.launch_plan}


def _slab_walk(d, tile_rows, kp):
    """The int8 routes' K walk (csrc/adc_tile.cuh Int8Walk): each 32-dim k
    step in whole or in the segments a slab boundary cuts it into, with
    the slab closed at its end. Yields ("seg", lo, hi) in global dims and
    ("close", g)."""
    gd = -(-d // tile_rows)

    def end_of(g):
        return min((g + 1) * tile_rows, d) if g < gd else float("inf")

    g, end = 0, end_of(0)
    for k in range(0, kp, 32):
        if end >= k + 32:
            yield ("seg", k, k + 32)
            if end == k + 32:
                yield ("close", g)
                g, end = g + 1, end_of(g + 1)
            continue
        lo = 0
        while lo < 32:
            hi = min(32, end - k)
            yield ("seg", k + lo, k + hi)
            lo = hi
            if k + hi == end:
                yield ("close", g)
                g, end = g + 1, end_of(g + 1)


@pytest.mark.parametrize("kernel,tile_rows", [
    ("imc", 64), ("imc", 128), ("imc", 256), ("imc", 100), ("imc", 7),
    ("multibit", 64), ("multibit", 128), ("multibit", 256),
    ("multibit", 40), ("multibit", 8)])
@pytest.mark.parametrize("b,d,c", [(1, 9, 3), (3, 130, 257), (5, 100, 50),
                                   (1024, 1024, 1024), (65, 1000, 129)])
def test_adc_plan_covers_b_c_and_every_slab_once(kernel, tile_rows, b, d,
                                                 c):
    """Blocks of 64 columns by 128 (imc) or 64 (multibit) queries cover B
    and C with no empty block; the slab walk
    cuts every dim into exactly one segment, closes slabs 0 .. gd - 1 in
    order, each at its end, and covers the int8 ring's k_stages; the
    fp32 steps (32 dims for imc's mainloop, 16 for multibit's SIMT tile)
    cover D; the convert pass has a block per 64 x 64 tile of
    the int8 copies; the scratch regions are 256-byte aligned and
    disjoint."""
    p = ADC_PLANS[kernel](b, d, c, tile_rows)
    gx, gy = p["grid"]
    rows = {"imc": asi.BLOCK_ROWS, "multibit": asm.BLOCK_ROWS}[kernel]
    assert gx * 64 >= c > (gx - 1) * 64 and gy * rows >= b > (gy - 1) * rows
    gd = p["slabs"]
    assert gd * tile_rows >= d > (gd - 1) * tile_rows
    kp = p["k_stages"] * 128
    assert kp >= d > kp - 128 and kp == p["kp"]
    st = {"imc": asi.FP32_STEP, "multibit": asm.FP32_STEP}[kernel]
    assert p["k_steps"] * st >= d > (p["k_steps"] - 1) * st
    seen = np.zeros(kp, dtype=int)
    closes, at = [], 0
    for ev in _slab_walk(d, tile_rows, kp):
        if ev[0] == "seg":
            _, lo, hi = ev
            assert lo == at < hi and hi - lo <= 32
            assert lo // 32 == (hi - 1) // 32
            seen[lo:hi] += 1
            at = hi
            # a segment never spans a slab boundary below D
            assert lo >= d or lo // tile_rows == (min(hi, d) - 1) // tile_rows
        else:
            closes.append(ev[1])
            assert at == min((ev[1] + 1) * tile_rows, d)
    assert (seen == 1).all() and closes == list(range(gd))
    n_am = (kp // 64) * gx if kernel == "imc" else 0
    assert p["n_am_tiles"] == n_am
    assert p["conv_grid"] == n_am + (kp // 64) * gy * rows // 64
    off, sizes = p["offsets"], {"q8": gy * rows * kp,
                                "am8": gx * 64 * kp if kernel == "imc" else 0,
                                "flags": 4 * p["conv_grid"], "keys": 8 * b,
                                "tickets": 4 * gy}
    names = list(sizes)
    for name, nxt in zip(names, names[1:] + [None]):
        assert off[name] % 256 == 0
        stop = off[nxt] if nxt else p["scratch_bytes"]
        assert off[name] + sizes[name] <= stop


@pytest.mark.parametrize("kernel", sorted(ADC_PLANS))
def test_adc_shared_memory_fits_a_block(kernel):
    """The dynamic shared memory is the kernel's constant: imc the larger
    of the int8 ring (4 stages of 128 query + 64 column rows of 128 bytes)
    and the fp32 ring (3 stages of 32 dims of both float tiles), then the
    128 x 65 float sum tile; multibit the ring (64 int8 query rows and up
    to 8 planes' bytes), the decoded code rows and the 64 x 65 sum tile. A
    block fits, with the static shared memory and 1 KB of reserve."""
    want = {"imc": 4 * 192 * 128 + 4 * 128 * 65,
            "multibit": 4 * (64 * 128 + 8 * 16 * 64) + 64 * 128
            + 4 * 64 * 65}[kernel]
    assert 3 * 192 * 32 * 4 <= 4 * 192 * 128  # the fp32 ring fits the int8
    for b, d, c in ((1, 8, 1), (1024, 1024, 1024), (7, 100_000, 3)):
        assert ADC_PLANS[kernel](b, d, c, 128)["smem"] == want
    assert want + 1024 <= SMEM_LIMIT


@pytest.mark.parametrize("kernel", sorted(ADC_PLANS))
def test_adc_plan_fills_one_wave_at_the_main_shape(kernel):
    """B = C = D = 1024 at 128-row arrays, blocks of 256 threads: imc 128
    blocks, one an SM (shared memory), on 128 of the 132 SMs; multibit 256
    blocks, two an SM. One wave."""
    p = ADC_PLANS[kernel](1024, 1024, 1024, 128)
    blocks = p["grid"][0] * p["grid"][1]
    per_sm = min(SMEM_PER_SM // (p["smem"] + 1024), 2048 // p["threads"])
    assert (blocks, p["threads"], per_sm) == {
        "imc": (128, 256, 1), "multibit": (256, 256, 2)}[kernel]
    assert 0.95 * H100_SMS <= blocks <= H100_SMS * per_sm


def _adc_count(p, e, clipq):
    """csrc/adc_tile.cuh adc_count: the ADC of integer partials p as
    counts of steps (step = 2^e), round half to even, in integers."""
    if e <= 0:
        v = p << -e
    else:
        fl = p >> e
        rem, half = p - (fl << e), 1 << (e - 1)
        v = fl + ((rem > half) | ((rem == half) & (fl & 1 == 1)))
    return np.clip(v, -clipq, clipq)


def _adc_model(q, u, offsets, tile_rows, tile_cols, adc_bits, adc_clip,
               qmax=0, int_close=False):
    """The int8 routes' arithmetic in numpy: the walk of _slab_walk, each
    segment an exact integer product of the int8 queries (0 past D) and
    the codes u (am_search_imc: the int8 AM; am_search_multibit: the u8
    offset codes), s32 on the card; a slab closes with float32(sum q*u -
    qmax * sum q) + offset, the ADC in float32 (a true division, round
    half to even, a product) and the float32 sum over slabs in order; or,
    with ``int_close`` (no offsets, a power-of-two step), with the integer
    count of steps (``_adc_count``), the counts summed and the sum times
    step. Returns (idx, sim) of the first-wins argmax."""
    b, d = q.shape
    c = u.shape[1]
    kp = -(-d // 128) * 128
    q8 = np.zeros((b, kp), np.int64)
    q8[:, :d] = q
    a8 = np.zeros((kp, c), np.int64)
    a8[:d] = u[:d]
    clip = np.float32(adc_clip)
    step = np.float32(2.0 * adc_clip / 2 ** adc_bits)
    total = np.zeros((b, c), np.float32)
    counts = np.zeros((b, c), np.int64)
    e = int(np.log2(step))
    if int_close:
        assert offsets is None and 2.0 ** e == step
    acc = np.zeros((b, c), np.int64)
    rs = np.zeros((b, 1), np.int64)
    for ev in _slab_walk(d, tile_rows, kp):
        if ev[0] == "seg":
            acc += q8[:, ev[1]:ev[2]] @ a8[ev[1]:ev[2]]
            rs += q8[:, ev[1]:ev[2]].sum(1, keepdims=True)
            continue
        g = ev[1]
        p = acc - qmax * rs
        assert np.abs(p).max() <= 2 ** 24
        if int_close:
            counts += _adc_count(p, e, int(clip / step))
            acc[:], rs[:] = 0, 0
            continue
        off = (np.zeros(c, np.float32) if offsets is None else
               np.repeat(offsets[g], tile_cols)[:c].astype(np.float32))
        x = np.minimum(np.maximum(p.astype(np.float32) + off, -clip), clip)
        total = total + np.rint(x / step).astype(np.float32) * step
        acc[:], rs[:] = 0, 0
    if int_close:
        total = counts.astype(np.float32) * step
    return total.argmax(1).astype(np.int32), total.max(1)


@pytest.mark.parametrize("d,tile_rows", [(130, 128), (130, 64), (100, 40),
                                         (256, 100), (33, 8), (9, 256),
                                         (300, 7)])
@pytest.mark.parametrize("adc_bits,offsets", [(16, False), (6, True),
                                              (3, True), (3, False)])
def test_imc_int8_model_equals_the_plain_search(d, tile_rows, adc_bits,
                                                offsets):
    """±1 and small-integer operands with duplicated columns (ties):
    the int8 route's arithmetic equals ref.am_search_imc bit for bit,
    slabs that end inside a 32-dim k step included; without offsets and
    at a power-of-two step, also its integer close."""
    rng = np.random.default_rng([31, d, tile_rows, adc_bits])
    b, c, cols = 6, 70, 32
    for q, am in ((rng.choice([-1, 1], (b, d)), rng.choice([-1, 1], (c, d))),
                  (rng.integers(-3, 4, (b, d)), rng.integers(-5, 6, (c, d)))):
        am = am[np.arange(c) % 23]
        gd, gc = -(-d // tile_rows), -(-c // cols)
        off = (np.round(rng.normal(0, 2, (gd, gc)) * 16) / 16
               ).astype(np.float32) if offsets else None
        kw = dict(tile_rows=tile_rows, tile_cols=cols, adc_bits=adc_bits,
                  adc_clip=float(tile_rows))
        qt = torch.as_tensor(q, dtype=torch.float32)
        at = torch.as_tensor(am.T, dtype=torch.float32)
        assert asi.int8_route(qt, at, tile_rows)
        w_idx, w_sim = ref.am_search_imc(
            qt, at, offsets=None if off is None else torch.as_tensor(off),
            **kw)
        closes = [False]
        step = 2.0 * kw["adc_clip"] / 2 ** adc_bits
        if off is None and 2.0 ** np.round(np.log2(step)) == step:
            closes.append(True)
        for int_close in closes:
            idx, sim = _adc_model(q, am.T, off, int_close=int_close, **kw)
            assert np.array_equal(idx, w_idx.numpy())
            assert np.array_equal(sim, w_sim.numpy())


@pytest.mark.parametrize("cell_bits", range(2, 9))
@pytest.mark.parametrize("d,tile_rows", [(130, 128), (100, 40), (33, 8),
                                         (1000, 256)])
def test_multibit_int8_model_equals_the_plain_search(cell_bits, d,
                                                     tile_rows):
    """u8 codes over the whole [0, 2^b - 1] (u = 2^b - 1 is code Qmax + 1,
    which recentred s8 would overflow at 8 bits) against ±1 queries:
    sum q*u - Qmax * sum q per slab equals ref.am_search_multibit bit for
    bit, with a 16-bit ADC and with a 4-bit ADC, with and without offsets
    (without them also through the integer close)."""
    rng = np.random.default_rng([32, cell_bits, d, tile_rows])
    b, c, cols = 5, 40, 16
    qmax = 2 ** (cell_bits - 1) - 1
    u = rng.integers(0, 2 ** cell_bits, (c, d))
    u[0] = 2 ** cell_bits - 1
    planes = ref.pack_planes(torch.as_tensor(u), cell_bits)
    q = rng.choice([-1, 1], (b, d))
    qt = torch.as_tensor(q, dtype=torch.float32)
    assert asm.int8_route(qt, cell_bits, tile_rows)
    codes = ref.unpack_planes(planes).numpy()  # (Dp*8, C) offset codes
    assert np.array_equal(codes[:d], u.T)
    gd, gc = -(-d // tile_rows), -(-c // cols)
    off = (np.round(rng.normal(0, 4, (gd, gc)) * 16) / 16).astype(np.float32)
    for adc_bits, o in ((16, None), (4, off), (4, None)):
        kw = dict(tile_rows=tile_rows, tile_cols=cols, adc_bits=adc_bits,
                  adc_clip=ref.multibit_adc_clip(cell_bits, tile_rows))
        w_idx, w_sim = ref.am_search_multibit(
            qt, planes, cell_bits=cell_bits,
            offsets=None if o is None else torch.as_tensor(o), **kw)
        for int_close in (False, True) if o is None else (False,):
            idx, sim = _adc_model(q, codes, o, qmax=qmax,
                                  int_close=int_close, **kw)
            assert np.array_equal(idx, w_idx.numpy())
            assert np.array_equal(sim, w_sim.numpy())


def test_adc_route_predicates():
    """The route tests mirrored from the search passes: int8 for ±1
    operands (and multi-bit codes), fp32 for a sigma 0.5 noisy AM, for a
    query of 200, for a non-integer query, and where a slab partial could
    exceed 2^24 (127 * 127 * 1041 rows)."""
    rng = np.random.default_rng(33)
    q = torch.as_tensor(rng.choice([-1.0, 1.0], (8, 256)), dtype=torch.float32)
    am_t = torch.as_tensor(rng.choice([-1.0, 1.0], (256, 40)),
                           dtype=torch.float32)
    noisy = am_t + 0.5 * torch.as_tensor(rng.normal(size=(256, 40)),
                                         dtype=torch.float32)
    big, frac = q.clone(), q.clone()
    big[3, 7] = 200.0
    frac[0, 0] = 0.5
    assert asi.int8_route(q, am_t, 128)
    assert not asi.int8_route(q, noisy, 128)
    assert not asi.int8_route(big, am_t, 128)
    assert not asi.int8_route(frac, am_t, 128)
    full = torch.full((2, 2048), 127.0)
    assert asi.int8_route(full, full.T, 1040)
    assert not asi.int8_route(full, full.T, 1041)
    for cb in range(2, 9):
        assert asm.int8_route(q, cb, 128)
        assert not asm.int8_route(big, cb, 128)
        assert not asm.int8_route(frac, cb, 128)
    assert asm.int8_route(full, 8, 1032) and not asm.int8_route(full, 8, 1033)


# -- am_search ---------------------------------------------------------------

@pytest.mark.parametrize("b,d,c", [(1, 9, 3), (3, 130, 257), (1024, 1024, 1024),
                                   (65, 1000, 129), (7, 100_000, 3)])
def test_am_search_plan_is_the_imc_search_with_one_slab_of_d(b, d, c):
    """am_search launches search_pass.cuh as am_search_imc does, with one
    slab of D: the same 128-query x 64-column grid, 256 threads and shared
    memory (under a block's limit at any D), one slab, the int8 ring's and
    the fp32 steps over D, and the same scratch (int8 copies of q and the
    AM, a flag per convert tile, a key per query, a ticket per row tile)."""
    p = ams.launch_plan(b, d, c)
    assert p == asi.launch_plan(b, d, c, d)
    gx, gy = p["grid"]
    assert gx * 64 >= c > (gx - 1) * 64 and gy * 128 >= b > (gy - 1) * 128
    assert p["slabs"] == 1 and p["threads"] == 256
    assert p["k_stages"] * 128 >= d > (p["k_stages"] - 1) * 128
    assert p["k_steps"] * 32 >= d > (p["k_steps"] - 1) * 32
    assert p["smem"] == asi.SMEM and p["smem"] + 1024 <= SMEM_LIMIT
    kp = p["kp"]
    assert p["conv_grid"] == (kp // 64) * (gx + 2 * gy)
    assert p["offsets"]["keys"] + 8 * b <= p["offsets"]["tickets"]
    assert p["offsets"]["tickets"] + 4 * gy <= p["scratch_bytes"]


def test_am_search_plan_fills_one_wave_at_the_main_shape():
    """B = C = D = 1024: 128 blocks of 256 threads, one an SM (their
    shared memory), on 128 of the 132 SMs."""
    p = ams.launch_plan(1024, 1024, 1024)
    gx, gy = p["grid"]
    per_sm = min(SMEM_PER_SM // (p["smem"] + 1024), 2048 // p["threads"])
    assert (gx * gy, per_sm) == (128, 1)


def test_am_search_route_predicate():
    """The search pass's route, mirrored on the CPU: int8 for ±1
    operands and for small integers with max|q| * max|am| * D <= 2^24;
    fp32 for dyadic non-integer queries or AM cells, for a query of 200
    (> 127), and where the dot could pass 2^24 (127 * 127 * 1041 dims)."""
    rng = np.random.default_rng(34)
    q = torch.as_tensor(rng.choice([-1.0, 1.0], (8, 256)),
                        dtype=torch.float32)
    am_t = torch.as_tensor(rng.choice([-1.0, 1.0], (256, 40)),
                           dtype=torch.float32)
    assert ams.int8_route(q, am_t)
    ints = torch.as_tensor(rng.integers(-127, 128, (8, 256)),
                           dtype=torch.float32)
    assert ams.int8_route(ints, am_t)
    dyadic = torch.as_tensor(rng.integers(-128, 128, (8, 256)) / 256,
                             dtype=torch.float32)
    assert not ams.int8_route(dyadic, am_t)
    assert not ams.int8_route(q, am_t * 0.5)
    big = q.clone()
    big[3, 7] = 200.0
    assert not ams.int8_route(big, am_t)
    full = torch.full((2, 1040), 127.0)
    assert ams.int8_route(full, full.T)
    full = torch.full((2, 1041), 127.0)
    assert not ams.int8_route(full, full.T)


# -- am_shortlist -------------------------------------------------------------

INVALID = (1 << 64) - 1


def _shortlist_plans():
    for b, g, s in ((1, 1, 1), (5, 45, 45), (32, 45, 45), (37, 448, 8),
                    (256, 448, 8), (256, 448, 16), (256, 448, 448),
                    (7, 1000, 3), (7, 1777, 1777), (3, 16461, 5),
                    (3, 16461, 600), (300, 129, 64)):
        for sms in (1, 78, 132, 10_000):
            yield b, g, s, sms


@pytest.mark.parametrize("b,g,s,sms", list(_shortlist_plans()))
def test_shortlist_plan_covers_every_row_and_column_once(b, g, s, sms):
    """Tile route: (query tiles of 16 rows) x (splits of cols columns, a
    multiple of 16, at most 512) cover every (row, column) once, the
    last split's columns past G masked; each split's top-min(S, cols)
    keys and the merge fit a warp's KPL keys a lane; the shared memory
    (the ring or the keys, whichever is larger) fits a block. Otherwise
    the stream route's block per query, its keys in shared memory up to
    SMEM_SLOTS."""
    pl = asl.launch_plan(b, 128, g, s, sms)
    if pl["route"] == "stream":
        assert pl["grid"] == (b, 1) and pl["threads"] == 256
        n_split = -(-g // asl._tile_cols(g, -(-g // asl.MAX_KEYS)))
        assert n_split * min(s, asl.MAX_KEYS) > asl.MAX_KEYS
        assert (pl["scratch_bytes"] == 0) == (g <= asl.SMEM_SLOTS)
        assert pl["smem"] <= SMEM_LIMIT
        return
    tiles, splits = pl["grid"]
    cols = pl["cols"]
    assert tiles * asl.ROWS >= b > (tiles - 1) * asl.ROWS
    assert cols % 16 == 0 and cols <= asl.MAX_KEYS
    assert splits == pl["splits"] and splits * cols >= g > (splits - 1) * cols
    seen = np.zeros((tiles * asl.ROWS, splits * cols), np.int64)
    for x, y in itertools.product(range(tiles), range(splits)):
        seen[x * 16:(x + 1) * 16, y * cols:(y + 1) * cols] += 1
    assert (seen == 1).all()
    merge = splits * min(s, cols) if splits > 1 else 0
    assert merge <= asl.MAX_KEYS
    assert 32 * pl["kpl"] >= max(cols, merge) > 32 * (pl["kpl"] - 2)
    assert pl["kpl"] % 2 == 0 and 2 <= pl["kpl"] <= 16
    ring = 4 * (16 * 48 + 32 * max(cols + 16, 32))
    assert pl["smem"] == max(ring, 8 * 16 * (32 * pl["kpl"] + 1))
    assert pl["smem"] <= SMEM_LIMIT
    assert pl["scratch_bytes"] == 8 * tiles * 16 * merge
    assert pl["ticket_bytes"] == (4 * tiles if splits > 1 else 0)


@pytest.mark.parametrize("sms", [1, 16, 78, 132, 10_000])
def test_shortlist_plan_follows_the_devices_sm_count(sms):
    """The plan takes the fewest G splits, or splits of MIN_SPLIT_COLS
    columns where that grid has at most one block an SM and their merge
    leaves a lane fewer keys: at B = 256, G = 448 one split of 448 on a
    16-SM device, 7 splits of 64 on an H100; at S = G never the narrow
    split; the served B = 32, G = 45 never splits."""
    for b, g, s in ((256, 448, 8), (256, 448, 16), (256, 448, 448),
                    (32, 45, 45), (7, 1000, 3), (7, 1000, 40),
                    (1024, 1000, 8), (300, 129, 64)):
        pl = asl.launch_plan(b, 128, g, s, sms)
        assert pl["sms"] == sms and pl["route"] == "tile"
        tiles, splits = pl["grid"]
        fewest = asl._tile_cols(g, -(-g // asl.MAX_KEYS))
        narrow = -(-g // asl.MIN_SPLIT_COLS)
        takes_narrow = (tiles * narrow <= sms
                        and asl.MIN_SPLIT_COLS < fewest
                        and narrow * min(s, asl.MIN_SPLIT_COLS) < fewest)
        assert pl["cols"] == (asl.MIN_SPLIT_COLS if takes_narrow
                              else fewest)
        if takes_narrow:
            assert tiles * splits <= sms
    assert asl.launch_plan(256, 128, 448, 8, 16)["grid"] == (16, 1)
    assert asl.launch_plan(256, 128, 448, 8, 132)["grid"] == (16, 7)
    assert asl.launch_plan(32, 128, 45, 45, 132)["grid"] == (2, 1)


@pytest.mark.parametrize("b", [16, 256, 512, 1024, 2048])
def test_shortlist_plan_spans_the_fewest_and_the_narrowest_splits(b):
    """The grids chip_smoke.py times against the plan's at the huge-label
    shape (G = 448, S = 8): a 1-SM device's plan takes the fewest splits
    (one block of all 448 columns a tile, no merge scratch or tickets), an
    unbounded one the narrowest (MIN_SPLIT_COLS columns), and the H100's
    the narrowest while that grid has at most one block an SM (B <= 288),
    else the fewest."""
    one = asl.launch_plan(b, 128, 448, 8, 1)
    assert one["grid"] == (b // 16, 1) and one["kpl"] == 14
    assert one["scratch_bytes"] == 0 and one["ticket_bytes"] == 0
    wide = asl.launch_plan(b, 128, 448, 8, 1 << 30)
    assert wide["cols"] == asl.MIN_SPLIT_COLS and wide["grid"] == (b // 16, 7)
    assert wide["kpl"] == 2 and wide["ticket_bytes"] == 4 * (b // 16)
    h100 = asl.launch_plan(b, 128, 448, 8, H100_SMS)
    assert h100["grid"] == (wide if 7 * (b // 16) <= H100_SMS
                            else one)["grid"]


def _warp_select(keys, k):
    """A numpy model of csrc/am_shortlist.cu warp_select: lane l holds
    keys[l + 32 i]; nv and the counts are warp sums, h* the least hamming
    with >= min(k, nv) keys at or below it (a binary search between the
    least and the largest), the candidates compacted slot by slot in lane
    order, each ranked by the candidates below it. Returns the k output
    slots (INVALID where exhausted)."""
    kpl = -(-len(keys) // 32)
    reg = np.full((kpl, 32), INVALID, dtype=np.uint64)
    reg.reshape(-1)[:len(keys)] = keys
    ham = (reg >> np.uint64(32)).astype(np.int64)
    valid = reg != np.uint64(INVALID)
    nv = int(valid.sum())
    keff = min(k, nv)
    out = [INVALID] * k
    if keff == 0:
        return out
    lo, hi = int(ham[valid].min()), int(ham[valid].max())
    while lo < hi:
        mid = lo + (hi - lo) // 2
        if int((valid & (ham <= mid)).sum()) >= keff:
            hi = mid
        else:
            lo = mid + 1
    cand = valid & (ham <= lo)
    lst = [int(v) for v in reg[cand]]  # slot-major, lane order
    for v in lst:
        rank = sum(w < v for w in lst)
        if rank < keff:
            assert out[rank] == INVALID  # ranks are unique
            out[rank] = v
    return out


def _shortlist_model(ham, s, cols):
    """Every row's top S of (hamming << 32 | id), through G splits of
    ``cols`` columns, each split's top-min(S, cols) (its ragged tail
    exhausted), then the merge of the splits' keys, as the tile route."""
    b, g = ham.shape
    ids = np.arange(g, dtype=np.uint64)
    keys = (ham.astype(np.uint64) << np.uint64(32)) | ids
    n_split = -(-g // cols)
    rows = []
    for r in range(b):
        if n_split == 1:
            rows.append(_warp_select(keys[r], s))
            continue
        s_eff = min(s, cols)
        part = []
        for y in range(n_split):
            part += _warp_select(keys[r, y * cols:(y + 1) * cols], s_eff)
        rows.append(_warp_select(np.array(part, dtype=np.uint64), s))
    return np.array(rows, dtype=np.uint64)


@pytest.mark.parametrize("g,s,cols", [(45, 45, 48), (45, 1, 16),
                                      (448, 8, 64), (448, 16, 448),
                                      (448, 448, 448), (100, 40, 16),
                                      (130, 9, 32), (9, 9, 16), (300, 7, 64)])
def test_shortlist_split_merge_and_warp_selection_are_exact(g, s, cols):
    """The tile route's selection, modelled in numpy, equals the (-sim,
    id) order of ref.am_shortlist: ties forced by repeated hammings (few
    distinct values), S = G, S past a split's columns (the split's own
    top-cols), ragged last splits."""
    rng = np.random.default_rng([36, g, s, cols])
    for ham in (rng.integers(0, 6, (5, g)), rng.integers(400, 600, (5, g)),
                np.full((2, g), 17)):
        got = _shortlist_model(ham, s, cols)
        order = np.lexsort((np.broadcast_to(np.arange(g), ham.shape), ham),
                           axis=1)[:, :s]
        assert np.array_equal((got & np.uint64(0xffffffff)).astype(np.int64),
                              order)
        assert np.array_equal((got >> np.uint64(32)).astype(np.int64),
                              np.take_along_axis(ham, order, axis=1))


def test_shortlist_model_matches_the_plain_version_on_packed_rows():
    """End to end on packed operands: hamming from the bits, then the
    model's top S at the huge-label plan's split equals ref.am_shortlist
    (ids and sims = D - 2 hamming)."""
    rng = np.random.default_rng(37)
    d, g = 100, 448
    q = rng.choice([-1.0, 1.0], (6, d)).astype(np.float32)
    sup = rng.choice([-1.0, 1.0], (g, d)).astype(np.float32)
    sup[200:] = sup[:248]  # duplicated super-centroids: ties
    ham = (q[:, None, :] != sup[None, :, :]).sum(axis=2)
    qp = ref.pack_rows(torch.as_tensor(q))
    spt = ref.pack_rows(torch.as_tensor(sup)).T.contiguous()
    for s in (1, 8, 16, 448):
        pl = asl.launch_plan(6, 13, g, s, H100_SMS if s < 448 else 1)
        got = _shortlist_model(ham, s, pl["cols"])
        w_idx, w_sim = ref.am_shortlist(qp, spt, d, s)
        assert np.array_equal((got & np.uint64(0xffffffff)).astype(np.int64),
                              w_idx.numpy())
        assert np.array_equal(d - 2 * (got >> np.uint64(32)).astype(np.int64),
                              w_sim.numpy().astype(np.int64))


def test_shortlist_on_the_cpu_is_the_plain_version():
    """CPU operands take ref.am_shortlist, whatever the SM count asked
    for, and launch nothing; a shortlist outside [1, G] is refused."""
    rng = np.random.default_rng(39)
    q = ref.pack_rows(torch.as_tensor(rng.choice([-1.0, 1.0], (5, 100))))
    spt = ref.pack_rows(torch.as_tensor(
        rng.choice([-1.0, 1.0], (45, 100)))).T.contiguous()
    n = asl.am_shortlist.launches
    want = ref.am_shortlist(q, spt, 100, 7)
    got = asl.am_shortlist(q, spt, n_dims=100, s=7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for sms in (1, 132):
        got = asl._launch(q, spt, 100, 7, sms)
        assert got[2] is None
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert asl.am_shortlist.launches == n
    for s in (0, 46):
        with pytest.raises(ValueError, match="outside"):
            asl.am_shortlist(q, spt, n_dims=100, s=s)


# -- pack_bits / unpack_bits ------------------------------------------------

@pytest.mark.parametrize("sms", [1, 78, 132, 144, 10_000])
def test_pack_plan_follows_the_devices_sm_count(sms):
    """A warp per chunk of 128 packed bytes (1024 floats), 8 warps a
    block, at most 8 blocks per SM of the device the plan is made for
    (the launcher refuses a plan for another SM count); more chunks
    stride over the grid. R = C = 1024 is 128 blocks of one chunk a warp
    on an H100; the first version capped its grid at a hard-coded
    132 * 16 blocks."""
    from repro_torch.kernels import pack_bits as pb
    for n in (1, 127, 128, 129, 1024 * 128, 8500 * 128, 10 ** 8):
        pl = pb.launch_plan(n, sms)
        chunks = -(-n // 128)
        assert pl["sms"] == sms and pl["threads"] == 256
        assert pl["grid"] == min(-(-chunks // 8), 8 * sms)
        assert pl["grid"] * 8 >= chunks or pl["grid"] == 8 * sms
    assert pb.launch_plan(1024 * 128, 132)["grid"] == 128
