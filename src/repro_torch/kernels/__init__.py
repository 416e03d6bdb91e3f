"""The port's serving kernels: hand-written CUDA for Hopper (``csrc/``),
each with a plain PyTorch version in ``ref`` and a launch counter on its
wrapper."""
from repro_torch.kernels import am_search_packed as _asp
from repro_torch.kernels import encode_fused as _ef
from repro_torch.kernels import pack_bits as _pb

# The wrappers whose ``.launches`` count CUDA kernel launches.
KERNELS = {"pack_bits": _pb.pack_bits,
           "am_search_packed": _asp.am_search_packed,
           "encode_pack": _ef.encode_pack}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
