"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each with
a plain PyTorch version in ``ref`` and a launch counter on its wrapper."""
from repro_torch.kernels import am_search as _as
from repro_torch.kernels import am_search_imc as _asi
from repro_torch.kernels import am_search_multibit as _asm
from repro_torch.kernels import am_search_packed as _asp
from repro_torch.kernels import am_search_sparse as _ass
from repro_torch.kernels import am_shortlist as _asl
from repro_torch.kernels import binary_mvm as _bm
from repro_torch.kernels import encode_fused as _ef
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import pack_bits as _pb
from repro_torch.kernels import qail_update as _qu
from repro_torch.kernels import ssd_chunk as _sc

# name -> (wrapper, attribute): the counter of CUDA kernel launches. The
# packed search counts its two modes apart.
KERNELS = {"pack_bits": (_pb.pack_bits, "launches"),
           "am_search_packed": (_asp.am_search_packed, "launches"),
           "encode_pack": (_ef.encode_pack, "launches"),
           "qail_update": (_qu.qail_update, "launches"),
           "am_search": (_as.am_search, "launches"),
           "am_search_packed_unpack": (_asp.am_search_packed,
                                       "unpack_launches"),
           "binary_mvm": (_bm.binary_mvm, "launches"),
           "unpack_bits": (_pb.unpack_bits, "launches"),
           "am_search_imc": (_asi.am_search_imc, "launches"),
           "am_search_multibit": (_asm.am_search_multibit, "launches"),
           "am_shortlist": (_asl.am_shortlist, "launches"),
           "am_search_sparse": (_ass.am_search_sparse, "launches"),
           "am_search_sparse_gathered": (_ass.am_search_sparse_gathered,
                                         "launches"),
           "flash_decode": (_fd.flash_decode, "launches"),
           "ssd_chunk": (_sc.ssd_chunk, "launches")}


# Launches by configuration, on the wrappers whose tile the autotuner
# picks: {block_b or SGEMM_TILES index: launches}.
CONFIG_COUNTS = {"am_search_packed": (_asp.am_search_packed,
                                      "block_b_launches"),
                 "qail_update": (_qu.qail_update, "block_b_launches"),
                 "encode_pack": (_ef.encode_pack, "tile_launches")}


# Launches by route, beside the launches by configuration:
# {route: launches} of ``am_search_packed``'s popcount mode ("tile" or
# "sweep", picked from the shape by ``am_search_packed.launch_plan``).
ROUTE_COUNTS = {"am_search_packed": (_asp.am_search_packed,
                                     "route_launches")}


def reset_launches() -> None:
    """Zero every launch counter, the launches by configuration and by
    route, and the route counts of ``qail_update``, ``am_search``,
    ``am_search_imc``, ``am_search_multibit`` and ``am_shortlist``."""
    for fn, attr in KERNELS.values():
        setattr(fn, attr, 0)
    for fn, attr in CONFIG_COUNTS.values():
        getattr(fn, attr).clear()
    for fn, attr in ROUTE_COUNTS.values():
        counts = getattr(fn, attr)
        counts.update(dict.fromkeys(counts, 0))
    for mod in (_qu, _as, _asi, _asm, _asl):
        mod.reset_routes()


def launches() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def config_launches() -> dict[str, dict[int, int]]:
    """Launches by configuration since the last reset:
    ``{"am_search_packed": {block_b: n}, "qail_update": {block_b: n},
    "encode_pack": {tile: n}}``."""
    return {name: dict(getattr(fn, attr))
            for name, (fn, attr) in CONFIG_COUNTS.items()}


def route_launches() -> dict[str, dict[str, int]]:
    """Launches by route since the last reset:
    ``{"am_search_packed": {"tile": n, "sweep": n}}``."""
    return {name: dict(getattr(fn, attr))
            for name, (fn, attr) in ROUTE_COUNTS.items()}
