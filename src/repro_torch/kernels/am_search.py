"""Associative search over the unpacked AM: similarity + first-wins argmax.

Port of ``repro.kernels.am_search`` (``csrc/am_search.cu``). The kernel
computes sims = q @ am_t and keeps the first maximal column per query.
``am_t`` may be any strided (D, C) view, so the transposed view of a
resident (C, D) AM is searched without a copy.

The kernel picks its route on the device, per call: when q and the AM
view are integers in [-127, 127] and max|q| * max|am| * D <= 2^24
(``int8_route``: ±1 queries against the ±1 AM, the unpacked serving
path) the products run exactly on the int8 tensor cores; otherwise
(float or dyadic queries) in true fp32 FMAs (no TF32), summed in
increasing k. ``route_counts()`` reads how many calls took each route
(one device sync); ``reset_routes()`` zeroes them. ``launch_plan`` is
the kernel's grid, slab walk, shared memory and scratch (those of
``am_search_imc`` with one slab of D and no ADC), handed to the
launcher, which refuses any other.

A CPU tensor is searched by the plain version (``ref.am_search``); a
CUDA tensor goes through the kernel or raises. ``am_search.launches``
counts kernel calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels import _search_pass as sp

ROUTES = _build.RouteCounts.NAMES
_ROUTES = _build.RouteCounts()
TILE = 128  # IMC array dim: one (128, 128) tile of the AM is one cycle


def imc_cycles_for(am_t_shape: tuple) -> int:
    """ceil(D/128) * ceil(C/128) array passes per query for a (D, C) AM:
    the reference's ``am_search.imc_cycles_for``, equal to
    ``core.imc.map_memhd(D, C).cycles``."""
    d, c = am_t_shape
    return (-(-d // TILE)) * (-(-c // TILE))


def launch_plan(b: int, d: int, c: int) -> dict:
    """The launch for B queries against a (D, C) AM: the search pass of
    ``csrc/search_pass.cuh`` with one slab of D."""
    return sp.search_plan(b, d, c, d)


def int8_route(q: torch.Tensor, am_t: torch.Tensor) -> bool:
    """Whether the kernel takes its int8 route for these operands: the
    search pass's test of the convert pass's flags, mirrored."""
    return sp.int8_route(q, am_t, q.shape[1])


def routes(device: torch.device) -> torch.Tensor:
    """The (2,) int32 device counter of calls per route on ``device``."""
    return _ROUTES.tensor(device)


def route_counts() -> dict[str, int]:
    """Calls per route since the last reset, over all devices."""
    return _ROUTES.counts()


def reset_routes() -> None:
    _ROUTES.reset()


def am_search(q: torch.Tensor, am_t: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the multi-centroid AM.

    Args:
      q: (B, D) float32 queries.
      am_t: (D, C) float32 transposed bipolar AM (column c = centroid c),
        any strides.

    Returns:
      (best_idx, best_sim): (B,) int32 winning centroid (first wins ties)
      and (B,) float32 its dot similarity.
    """
    b, d = q.shape
    d2, c = am_t.shape
    if d != d2:
        raise ValueError(f"widths differ: {tuple(q.shape)} vs "
                         f"{tuple(am_t.shape)}")
    if c == 0:
        raise ValueError("the AM has no columns")
    if q.device != am_t.device:
        raise ValueError("q and am_t on different devices")
    if q.device.type == "cpu":
        return ref.am_search(q, am_t)
    if q.device.type != "cuda":
        raise ValueError(f"am_search: unsupported device {q.device}")
    _build.check_operand(q, "q", torch.float32, 2)
    _build.check_operand(am_t, "am_t", torch.float32, 2, contiguous=False)
    idx = torch.empty((b,), dtype=torch.int32, device=q.device)
    sim = torch.empty((b,), dtype=torch.float32, device=q.device)
    if b == 0:
        return idx, sim
    if d == 0:
        raise ValueError("the AM has no dims")
    p = launch_plan(b, d, c)
    scratch = torch.empty((p["scratch_bytes"],), dtype=torch.uint8,
                          device=q.device)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.am_search_launch(
            q.data_ptr(), am_t.data_ptr(), am_t.stride(0), am_t.stride(1),
            scratch.data_ptr(), p["scratch_bytes"],
            routes(q.device).data_ptr(), idx.data_ptr(), sim.data_ptr(), b,
            d, c, *sp.launch_args(p), _build.stream_of(q))
    _build.check(err, "am_search")
    am_search.launches += 1
    return idx, sim


am_search.launches = 0
