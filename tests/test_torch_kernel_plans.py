"""The pure-Python launch planning of the port's wrappers, on the CPU.

``flash_decode``'s split of S and shared-memory count, and the block
tiles of the fp32 mainloop that ``binary_mvm`` and ``encode_pack`` share
(``csrc/sgemm_tile.cuh``). The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import binary_mvm as bm  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402

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
