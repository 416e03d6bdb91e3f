"""MEMHD on PyTorch and CUDA: the port of the ``repro`` JAX package.

The package keeps the JAX package's module layout and names
(``repro_torch.core.am`` is the counterpart of ``repro.core.am``) and
imports neither jax nor any module of ``repro``. Its serving kernels
(``pack_bits``, ``am_search_packed``, ``encode_pack``) are hand-written
CUDA C++ for Hopper (``kernels/csrc``), built with nvcc at first use.

Every entry point runs on the GPU unless the caller passes
``device="cpu"``; without a GPU it raises instead of silently running on
the CPU (``resolve_device``).
"""
from __future__ import annotations

import torch

# The encoder's sign bits depend on full-fp32 products: TF32 keeps ~10
# mantissa bits and flips signs of H near zero against the reference.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it raises when there is none rather than
    carrying on on the CPU. An explicit ``"cpu"`` (the tests) is honoured;
    an explicit CUDA device also raises when CUDA is unavailable.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def on_device(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: tensors are moved (a no-op when
    already there), anything else (numpy, lists) is copied."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(x, device=device)


def generator(seed: int, device) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` — the port's stand-in
    for a ``jax.random.key`` (the streams differ from JAX's)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g
