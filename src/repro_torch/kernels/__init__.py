"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each with
a plain PyTorch version in ``ref`` and a launch counter on its wrapper."""
from repro_torch.kernels import am_search as _as
from repro_torch.kernels import am_search_packed as _asp
from repro_torch.kernels import encode_fused as _ef
from repro_torch.kernels import pack_bits as _pb
from repro_torch.kernels import qail_update as _qu

# name -> (wrapper, attribute): the counter of CUDA kernel launches. The
# packed search counts its two modes apart.
KERNELS = {"pack_bits": (_pb.pack_bits, "launches"),
           "am_search_packed": (_asp.am_search_packed, "launches"),
           "encode_pack": (_ef.encode_pack, "launches"),
           "qail_update": (_qu.qail_update, "launches"),
           "am_search": (_as.am_search, "launches"),
           "am_search_packed_unpack": (_asp.am_search_packed,
                                       "unpack_launches")}


def reset_launches() -> None:
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)


def launches() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}
