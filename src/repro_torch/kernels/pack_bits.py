"""1-bit packing of bipolar rows and its inverse: wrappers of the
``pack_bits`` and ``unpack_bits`` CUDA kernels.

Port of ``repro.kernels.pack_bits`` (``csrc/pack_bits.cu``). A CPU
tensor goes through the plain version (``ref.pack_bits``,
``ref.unpack_bits``); a CUDA tensor through the kernel or raises.
``pack_bits.launches`` and ``unpack_bits.launches`` count kernel
launches. ``launch_plan`` is both kernels' grid, computed here from the
device's SM count so that the CPU tests can check it, and handed to the
launchers, which refuse any other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.obs.trace import traced

# csrc/pack_bits.cu: threads of a block (a warp a chunk of 128 packed
# bytes, 1024 floats), and blocks per SM before the grid strides.
THREADS, CHUNK_BYTES, BLOCKS_PER_SM = 256, 128, 8


def launch_plan(n_bytes: int, sms: int) -> dict:
    """Both kernels' launch for ``n_bytes`` packed bytes on a device of
    ``sms`` SMs (``multi_processor_count``; 132 on an H100): a warp per
    chunk of 128 packed bytes, 8 warps a block, at most 8 blocks per SM
    (further chunks in a grid-stride loop)."""
    chunks = -(-n_bytes // CHUNK_BYTES)
    blocks = -(-chunks // (THREADS // 32))
    return {"grid": min(blocks, BLOCKS_PER_SM * sms), "threads": THREADS,
            "sms": sms}


def _plan(n_bytes: int, device) -> tuple:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    p = launch_plan(n_bytes, sms)
    return p["grid"], p["threads"], p["sms"]


@traced("launch.pack_bits")
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
    out = torch.empty((r, c // 8), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.pack_bits_launch(x.data_ptr(), out.data_ptr(),
                                   out.numel(), *_plan(out.numel(), x.device),
                                   _build.stream_of(x))
    _build.check(err, "pack_bits")
    pack_bits.launches += 1
    return out


pack_bits.launches = 0


def unpack_bits(packed: torch.Tensor, n_cols: int | None = None,
                ) -> torch.Tensor:
    """(R, C // 8) uint8 -> (R, C) float32 {-1, +1}, bit 1 -> +1.

    ``n_cols``: the unpacked width C the caller expects; a packed width
    that does not unpack to it (C not a multiple of 8: the tail of a
    ragged row is not recoverable here) raises.
    """
    if packed.dim() != 2:
        raise ValueError(f"unpack_bits takes (R, C/8), got "
                         f"{tuple(packed.shape)}")
    r, cb = packed.shape
    if n_cols is not None and n_cols != cb * 8:
        raise ValueError(f"C={n_cols} must be a multiple of 8 equal to "
                         f"8 * {cb} packed bytes")
    if packed.device.type == "cpu":
        return ref.unpack_bits(packed)
    if packed.device.type != "cuda":
        raise ValueError(f"unpack_bits: unsupported device {packed.device}")
    _build.check_operand(packed, "packed", torch.uint8, 2)
    out = torch.empty((r, cb * 8), dtype=torch.float32,
                      device=packed.device)
    if out.numel() == 0:
        return out
    lib = _build.lib()
    with torch.cuda.device(packed.device):
        err = lib.unpack_bits_launch(packed.data_ptr(), out.data_ptr(),
                                     packed.numel(),
                                     *_plan(packed.numel(), packed.device),
                                     _build.stream_of(packed))
    _build.check(err, "unpack_bits")
    unpack_bits.launches += 1
    return out


unpack_bits.launches = 0
