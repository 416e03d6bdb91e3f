"""Coarse pass of the hierarchical AM search: the top-S cluster shortlist.

Port of ``repro.kernels.am_shortlist`` (``csrc/am_shortlist.cu``). Each
query is scored against the G packed super-centroids (one per cluster of
the trained AM) by XOR + popcount, sim = D - 2 * hamming, and the S best
clusters are kept, ordered by (-sim, cluster id): among equal
similarities the lower cluster id comes first, as in ``ref.am_shortlist``.
Every similarity is an integer, so kernel and plain version agree bit for
bit.

A CPU tensor goes through the plain version (``ref.am_shortlist``); a
CUDA tensor through the kernel or raises. ``am_shortlist.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

NEG = ref.NEG
_SENT = ref._SENT
# Candidates whose keys a block keeps in shared memory (8 bytes each);
# beyond it the kernel streams them through a global scratch buffer. A
# kernel that also stages tiles in shared memory (am_search_sparse's ring)
# counts them against the same 8 * SMEM_SLOTS bytes.
SMEM_SLOTS = 16384


def topk_select(sims: torch.Tensor, ids: torch.Tensor, k: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of (sims, ids) pairs ordered by (-sim, id), as k
    iterated max-then-min-id selections (the TPU kernels' epilogue).

    sims: (B, N) float32, ids: (B, N) int32. Returns ((B, k) sims,
    (B, k) ids), best first; exhausted slots decay to (float32-min,
    int32-max). No composite sort key: an int32 (sim, id) pack overflows
    once D * C passes 2^31, and float keys lose id bits.
    """
    out_s, out_i = [], []
    for _ in range(k):
        m = sims.max(dim=1, keepdim=True).values
        pick = torch.where(sims == m, ids, _SENT).min(dim=1,
                                                       keepdim=True).values
        out_s.append(m)
        out_i.append(pick)
        drop = (sims == m) & (ids == pick)
        sims = torch.where(drop, NEG, sims)
        ids = torch.where(drop, _SENT, ids)
    return torch.cat(out_s, dim=1), torch.cat(out_i, dim=1)


def check_packed(q_packed: torch.Tensor, am_t: torch.Tensor, n_dims: int,
                 what: str) -> None:
    """Refuse packed operands whose widths or devices disagree."""
    if q_packed.dim() != 2 or am_t.dim() < 2:
        raise ValueError(f"{what}: bad ranks {tuple(q_packed.shape)}, "
                         f"{tuple(am_t.shape)}")
    dp = q_packed.shape[1]
    if am_t.shape[-2] != dp:
        raise ValueError(f"{what}: packed widths differ: "
                         f"{tuple(q_packed.shape)} vs {tuple(am_t.shape)}")
    if not dp * 8 >= n_dims > (dp - 1) * 8:
        raise ValueError(f"n_dims={n_dims} inconsistent with Dp={dp}")
    if q_packed.device != am_t.device:
        raise ValueError(f"{what}: operands on different devices")
    if q_packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q_packed.device}")


def keys_fit(slots: int, reserved: int = 0) -> bool:
    """Whether a block keeps its ``slots`` keys in shared memory beside
    ``reserved`` bytes of other staging."""
    return 8 * slots + reserved <= 8 * SMEM_SLOTS


def scratch(b: int, slots: int, device) -> torch.Tensor | None:
    """The global key buffer a block needs when its candidates do not fit
    in shared memory (None when they do)."""
    if keys_fit(slots):
        return None
    return torch.empty((b, slots), dtype=torch.int64, device=device)


def am_shortlist(q_packed: torch.Tensor, super_packed_t: torch.Tensor, *,
                 n_dims: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Score packed queries against G packed super-centroids, keep top S.

    Args:
      q_packed: (B, Dp) uint8 packed queries (``pack_rows``), tail bits 0.
      super_packed_t: (Dp, G) uint8 transposed packed super-centroids.
      n_dims: true hypervector dimension D.
      s: shortlist length, 1 <= s <= G.

    Returns:
      (cluster_idx, cluster_sims): (B, s) int32 and (B, s) float32,
      best first, ties toward the lower cluster id.
    """
    check_packed(q_packed, super_packed_t, n_dims, "am_shortlist")
    if super_packed_t.dim() != 2:
        raise ValueError("am_shortlist: super_packed_t must be (Dp, G)")
    b, dp = q_packed.shape
    g = super_packed_t.shape[1]
    if not 1 <= s <= g:
        raise ValueError(f"shortlist s={s} outside [1, {g}]")
    if q_packed.device.type == "cpu":
        return ref.am_shortlist(q_packed, super_packed_t, n_dims, s)
    _build.check_operand(q_packed, "q_packed", torch.uint8, 2)
    _build.check_operand(super_packed_t, "super_packed_t", torch.uint8, 2)
    idx = torch.empty((b, s), dtype=torch.int32, device=q_packed.device)
    sim = torch.empty((b, s), dtype=torch.float32, device=q_packed.device)
    if b == 0:
        return idx, sim
    buf = scratch(b, g, q_packed.device)
    lib = _build.lib()
    with torch.cuda.device(q_packed.device):
        err = lib.am_shortlist_launch(
            q_packed.data_ptr(), super_packed_t.data_ptr(),
            None if buf is None else buf.data_ptr(), idx.data_ptr(),
            sim.data_ptr(), b, dp, g, n_dims, s,
            _build.stream_of(q_packed))
    _build.check(err, "am_shortlist")
    am_shortlist.launches += 1
    return idx, sim


am_shortlist.launches = 0
