"""Projection MVM through 128x128 IMC-geometry tiles: wrapper of the
``binary_mvm`` CUDA kernel.

Port of ``repro.kernels.binary_mvm`` (``csrc/binary_mvm.cu``): H = x @ w
in true fp32 (no TF32: x is float features). A CPU tensor goes through
the plain version (``ref.binary_mvm``); a CUDA tensor through the kernel
or raises. ``binary_mvm.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

TILE = 128  # IMC array dim: one (K, N) tile pass is one array cycle


def binary_mvm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = x @ w. x: (B, K) float32; w: (K, N) float32 bipolar.
    Returns (B, N) float32."""
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
                                    out.data_ptr(), b, k, n,
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
