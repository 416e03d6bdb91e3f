"""Public dispatch surface of the port's kernel package.

Port of the serving dispatches of ``repro.kernels.ops``. Each keeps the
reference's ``use_kernel`` switch: a CUDA tensor with ``use_kernel=True``
is served by the hand-written CUDA kernel (tier ``cuda``); a CPU tensor,
or ``use_kernel=False``, by the plain PyTorch version (tier
``torch-ref``). Every call adds one to the ``(kernel, tier, geometry)``
dispatch counter, the port's ``kernel_dispatch_total``;
``dispatch_breakdown()`` sums it over geometries for the serving report.

Dispatches of kernels not ported yet (``binary_mvm``, ``unpack_bits``,
the imc/multibit/hierarchical searches) are absent; ROADMAP queue 2
lists them.
"""
from __future__ import annotations

import collections

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.am_search import am_search as _am_search
from repro_torch.kernels.am_search_packed import DEFAULT_BLOCK_B
from repro_torch.kernels.am_search_packed import (
    am_search_packed as _am_search_packed,
)
from repro_torch.kernels.am_search_packed import pack_rows as _pack_rows
from repro_torch.kernels.encode_fused import encode_pack as _encode_pack
from repro_torch.kernels.encode_fused import (
    predict_from_features as _predict_from_features,
)
from repro_torch.kernels.encode_fused import (
    search_from_features as _search_from_features,
)
from repro_torch.kernels.pack_bits import pack_bits as _pack_bits
from repro_torch.kernels.qail_update import (
    BLOCK_B_CHOICES as QAIL_BLOCK_B_CHOICES,
)
from repro_torch.kernels.qail_update import (
    DEFAULT_BLOCK_B as QAIL_DEFAULT_BLOCK_B,
)
from repro_torch.kernels.qail_update import qail_update as _qail_update

_DISPATCH: collections.Counter = collections.Counter()


def _count(kernel: str, tier: str, **dims) -> None:
    geometry = ",".join(f"{k}={v}" for k, v in sorted(dims.items()))
    _DISPATCH[(kernel, tier, geometry)] += 1


def _tier(x: torch.Tensor, use_kernel: bool) -> str:
    return "cuda" if use_kernel and x.device.type == "cuda" else "torch-ref"


def dispatch_breakdown() -> dict[str, dict[str, int]]:
    """{kernel: {tier: count}} summed over geometries."""
    out: dict[str, dict[str, int]] = {}
    for (k, t, _), n in sorted(_DISPATCH.items()):
        out.setdefault(k, {})
        out[k][t] = out[k].get(t, 0) + n
    return out


def reset_dispatch() -> None:
    _DISPATCH.clear()


def encode_pack(feats: torch.Tensor, projection: torch.Tensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """Fused encode + sign + bitpack: (B, f) -> (B, ceil(D/8)) uint8."""
    tier = _tier(feats, use_kernel)
    _count("encode_pack", tier, B=feats.shape[0], f=projection.shape[0],
           D=projection.shape[1])
    if tier == "torch-ref":
        return ref.encode_pack(feats, projection)
    return _encode_pack(feats.float().contiguous(), projection)


def search_from_features(feats: torch.Tensor, projection: torch.Tensor,
                         am_packed_t: torch.Tensor, *,
                         mode: str = "popcount", use_kernel: bool = True,
                         block_b: int = DEFAULT_BLOCK_B,
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Feature -> search chain over the packed AM: (best_idx, best_sim)."""
    tier = _tier(feats, use_kernel)
    _count("search_from_features", tier, B=feats.shape[0],
           D=projection.shape[1], C=am_packed_t.shape[1])
    if tier == "torch-ref":
        qp = ref.encode_pack(feats, projection)
        return ref.am_search_packed(qp, am_packed_t, projection.shape[1])
    return _search_from_features(feats.float().contiguous(), projection,
                                 am_packed_t, mode=mode, block_b=block_b)


def predict_from_features(feats: torch.Tensor, projection: torch.Tensor,
                          am_packed_t: torch.Tensor,
                          centroid_class: torch.Tensor, *,
                          mode: str = "popcount", use_kernel: bool = True,
                          block_b: int = DEFAULT_BLOCK_B) -> torch.Tensor:
    """End-to-end §III-D prediction from raw features: fused
    encode/pack -> packed search -> ownership gather."""
    tier = _tier(feats, use_kernel)
    _count("predict_from_features", tier, B=feats.shape[0],
           D=projection.shape[1], C=am_packed_t.shape[1])
    if tier == "torch-ref":
        return ref.predict_from_features(feats, projection, am_packed_t,
                                         centroid_class)
    return _predict_from_features(feats.float().contiguous(), projection,
                                  am_packed_t, centroid_class, mode=mode,
                                  block_b=block_b)


def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor, *,
                     n_dims: int, mode: str = "popcount",
                     use_kernel: bool = True,
                     block_b: int = DEFAULT_BLOCK_B,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search over the packed 1-bit AM."""
    tier = _tier(q_packed, use_kernel)
    _count("am_search_packed", tier, B=q_packed.shape[0], D=n_dims,
           C=am_packed_t.shape[1])
    if tier == "torch-ref":
        if mode == "unpack":
            return ref.am_search_packed_unpack(q_packed, am_packed_t, n_dims)
        return ref.am_search_packed(q_packed, am_packed_t, n_dims)
    return _am_search_packed(q_packed, am_packed_t, n_dims=n_dims,
                             mode=mode, block_b=block_b)


def pack_rows(x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """(B, D) bipolar -> (B, ceil(D/8)) uint8, any D (tail bits 0)."""
    tier = _tier(x, use_kernel)
    _count("pack_rows", tier, B=x.shape[0], D=x.shape[1])
    if tier == "torch-ref":
        return ref.pack_rows(x)
    return _pack_rows(x)


def pack_bits(x: torch.Tensor, *, use_kernel: bool = True) -> torch.Tensor:
    """(R, C) bipolar, C % 8 == 0 -> (R, C // 8) uint8."""
    tier = _tier(x, use_kernel)
    _count("pack_bits", tier, R=x.shape[0], C=x.shape[1])
    if tier == "torch-ref":
        return ref.pack_bits(x)
    return _pack_bits(x.float().contiguous())


def predict_packed(queries: torch.Tensor, am_packed_t: torch.Tensor,
                   centroid_class: torch.Tensor, *, n_dims: int,
                   mode: str = "popcount", use_kernel: bool = True,
                   ) -> torch.Tensor:
    """§III-D prediction over the packed residence: pack the bipolar
    queries, XOR+popcount search, ownership lookup."""
    qp = pack_rows(queries, use_kernel=use_kernel)
    idx, _ = am_search_packed(qp, am_packed_t, n_dims=n_dims, mode=mode,
                              use_kernel=use_kernel)
    return centroid_class[idx.long()]


def am_search(queries: torch.Tensor, am: torch.Tensor, *,
              use_kernel: bool = True,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search. queries: (B, D); am: (C, D) bipolar
    centroid rows, searched through its (D, C) transposed view (no
    copy). Returns (best_idx (B,) int32, best_sim (B,) float32)."""
    tier = _tier(queries, use_kernel)
    _count("am_search", tier, B=queries.shape[0], D=queries.shape[1],
           C=am.shape[0])
    if tier == "torch-ref":
        return ref.am_search(queries, am.T)
    return _am_search(queries.float().contiguous(), am.float().T)


def predict_classes(queries: torch.Tensor, am: torch.Tensor,
                    centroid_class: torch.Tensor, *,
                    use_kernel: bool = True) -> torch.Tensor:
    """End-to-end §III-D prediction: search + ownership lookup."""
    idx, _ = am_search(queries, am, use_kernel=use_kernel)
    return centroid_class[idx.long()]


def qail_update(q: torch.Tensor, upd: torch.Tensor, am_t: torch.Tensor,
                centroid_class: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, *, lr: float, use_kernel: bool = True,
                block_b: int | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused QAIL inner step (§III-C): sims + Eq. 4/5 + Eq.-(6) delta.

    q/upd: (B, D); am_t: (D, C) transposed binary AM (a view is fine);
    labels/mask: (B,). Returns (delta (C, D) float32, n_miss float32).
    ``block_b``: queries per similarity tile of the kernel, one of
    ``QAIL_BLOCK_B_CHOICES`` (None: the default); any choice gives the
    same result.
    """
    block_b = QAIL_DEFAULT_BLOCK_B if block_b is None else block_b
    if block_b not in QAIL_BLOCK_B_CHOICES:
        raise ValueError(f"block_b={block_b} not in {QAIL_BLOCK_B_CHOICES}")
    tier = _tier(q, use_kernel)
    _count("qail_update", tier, B=q.shape[0], D=am_t.shape[0],
           C=am_t.shape[1])
    if tier == "torch-ref":
        return ref.qail_update_delta(q, upd, am_t, centroid_class, labels,
                                     mask, lr)
    return _qail_update(q.float().contiguous(), upd.float().contiguous(),
                        am_t.float(), centroid_class.to(torch.int32),
                        labels.to(torch.int32), mask.float(), lr=lr,
                        block_b=block_b)
