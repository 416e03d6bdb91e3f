"""Projection MVM through 128x128 IMC-geometry tiles: wrapper of the
``binary_mvm`` CUDA kernel.

Port of ``repro.kernels.binary_mvm`` (``csrc/binary_mvm.cu``): H = x @ w
in true fp32 (no TF32: x is float features), one fused multiply-add per
term in increasing k, through a pipelined ``cp.async`` mainloop shared
with ``encode_pack``. A CPU tensor goes through
the plain version (``ref.binary_mvm``); a CUDA tensor through the kernel
or raises. ``binary_mvm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.obs.trace import traced

TILE = 128  # IMC array dim: one (K, N) tile pass is one array cycle

# The block tiles of the shared fp32 mainloop (``csrc/sgemm_tile.cuh``),
# indexed as the launchers' ``tile`` argument: (rows BM, columns BN, rows
# per thread TM, threads, K step BK). Each thread owns TM rows x 8
# consecutive columns. SGEMM_TILE is the one binary_mvm and encode_pack
# launch, the fastest of a sweep at B = 1024, K = 784, N = 1024 on the H100
# (chip_smoke.py prints the sweep).
SGEMM_TILES = ((128, 64, 4, 256, 32), (64, 64, 4, 128, 32),
               (128, 128, 8, 256, 32), (64, 64, 8, 64, 16))
SGEMM_TILE = 3
SGEMM_STAGES = 3  # cp.async ring stages of the mainloop (NST)


def sgemm_smem(tile: int) -> int:
    """Dynamic shared bytes of a block of tile ``SGEMM_TILES[tile]``: the
    ring of ``SGEMM_STAGES`` stages of a (BM, BK) A slab and a (BK, BN) B
    slab of floats (``Tile::SMEM`` in ``csrc/sgemm_tile.cuh``)."""
    bm, bn, _, _, bk = SGEMM_TILES[tile]
    return 4 * SGEMM_STAGES * (bm * bk + bk * bn)


def sgemm_grid(b: int, n: int, tile: int = SGEMM_TILE) -> tuple[int, int]:
    """(column blocks, row blocks) of the launch: every output of a
    (b, n) product in exactly one block."""
    bm, bn = SGEMM_TILES[tile][:2]
    return -(-n // bn), -(-b // bm)


def binary_mvm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = x @ w. x: (B, K) float32; w: (K, N) float32 bipolar.
    Returns (B, N) float32."""
    return binary_mvm_tiled(x, w, SGEMM_TILE)


@traced("launch.binary_mvm")
def binary_mvm_tiled(x: torch.Tensor, w: torch.Tensor,
                     tile: int) -> torch.Tensor:
    """``binary_mvm`` through block tile ``SGEMM_TILES[tile]`` (the
    sweep's entry; counted as a launch of ``binary_mvm``)."""
    b, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"widths differ: {tuple(x.shape)} vs "
                         f"{tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("x and w on different devices")
    if x.device.type == "cpu":
        return ref.binary_mvm(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"binary_mvm: unsupported device {x.device}")
    _build.check_operand(x, "x", torch.float32, 2)
    _build.check_operand(w, "w", torch.float32, 2)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.binary_mvm_launch(x.data_ptr(), w.data_ptr(),
                                    out.data_ptr(), b, k, n, tile,
                                    _build.stream_of(x))
    _build.check(err, "binary_mvm")
    binary_mvm.launches += 1
    return out


binary_mvm.launches = 0


def imc_cycles_for(x_shape: tuple, w_shape: tuple) -> int:
    """ceil(K/128) * ceil(N/128) array passes per sample — the IMC cycle
    count of ``core.imc.map_basic(K, N)`` (the batch reuses the resident
    weights, so it does not enter)."""
    k, n = w_shape
    return (-(-k // TILE)) * (-(-n // TILE))
