"""1-bit packing of bipolar rows: wrapper of the ``pack_bits`` CUDA kernel.

Port of ``repro.kernels.pack_bits.pack_bits`` (``csrc/pack_bits.cu``).
A CPU tensor is packed by the plain version (``ref.pack_bits``); a CUDA
tensor goes through the kernel or raises. ``pack_bits.launches`` counts
kernel launches.

``unpack_bits`` has no CUDA kernel yet (ROADMAP queue 2, item 2).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(R, C) float32 bipolar, C % 8 == 0 -> (R, C // 8) uint8,
    LSB-first, bit 1 iff x > 0."""
    if x.dim() != 2:
        raise ValueError(f"pack_bits takes (R, C), got {tuple(x.shape)}")
    r, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    if x.device.type == "cpu":
        return ref.pack_bits(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_bits: unsupported device {x.device}")
    _build.check_operand(x, "x", torch.float32, 2)
    if x.data_ptr() % 16:
        raise ValueError("pack_bits: x must be 16-byte aligned "
                         "(the kernel loads float4)")
    out = torch.empty((r, c // 8), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.pack_bits_launch(x.data_ptr(), out.data_ptr(),
                                   out.numel(), _build.stream_of(x))
    _build.check(err, "pack_bits")
    pack_bits.launches += 1
    return out


pack_bits.launches = 0


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    if packed.device.type == "cpu":
        return ref.unpack_bits(packed)
    raise NotImplementedError(
        "the unpack_bits CUDA kernel is not ported yet "
        "(ROADMAP queue 2, item 2)")
