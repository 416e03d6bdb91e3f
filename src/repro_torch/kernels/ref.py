"""Plain PyTorch versions of the port's kernels.

These are the *semantics* of the CUDA kernels in ``csrc/``, written as
ordinary tensor code: the wrappers use them for CPU tensors, the tests
hold them against the JAX package's Pallas kernels, and ``chip_smoke.py``
holds each CUDA kernel against them on the card. Keep them boring and
obviously correct.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def binary_mvm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """H = x @ w in float32. x: (B, K); w: (K, N) bipolar."""
    return x.float() @ w.float()


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """Pack (R, C) values, C % 8 == 0, into (R, C // 8) uint8, 8 cells
    per byte, LSB-first; a cell is "1" iff x > 0."""
    r, c = x.shape
    if c % 8:
        raise ValueError(f"C={c} must be a multiple of 8")
    bits = (x > 0).to(torch.int32).reshape(r, c // 8, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=x.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_bits: (R, C//8) uint8 -> (R, C) float32 {-1, +1}."""
    r, cb = packed.shape
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(r, cb * 8).float() * 2 - 1


def pack_rows(x: torch.Tensor) -> torch.Tensor:
    """(B, D) bipolar -> (B, ceil(D/8)) uint8; tail bits packed as 0
    (the tail is padded with -1, which packs as bit 0)."""
    pad = -x.shape[-1] % 8
    x = x.float()
    if pad:
        x = F.pad(x, (0, pad), value=-1.0)
    return pack_bits(x)


def hamming_distances(q_packed: torch.Tensor,
                      am_packed_t: torch.Tensor) -> torch.Tensor:
    """popcount(XOR) distances: (B, Dp) u8, (Dp, C) u8 -> (B, C) int32."""
    x = torch.bitwise_xor(q_packed.to(torch.int32)[:, :, None],
                          am_packed_t.to(torch.int32)[None, :, :])
    v = x - ((x >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    pc = (v + (v >> 4)) & 0x0F
    return pc.sum(dim=1, dtype=torch.int32)


def am_search_packed(q_packed: torch.Tensor, am_packed_t: torch.Tensor,
                     n_dims: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed-domain associative search: (best_idx int32, best_sim f32),
    sim = n_dims - 2 * hamming, first-wins on ties (``torch.max`` over a
    dim returns the first maximal index)."""
    sims = (n_dims - 2 * hamming_distances(q_packed, am_packed_t)).float()
    best_sim, best_idx = sims.max(dim=-1)
    return best_idx.to(torch.int32), best_sim


NEG = float(torch.finfo(torch.float32).min)  # exhausted top-k slot sim
_SENT = int(torch.iinfo(torch.int32).max)    # id sentinel of masked columns


def _rank_by_sim_then_id(sims: torch.Tensor,
                         ids: torch.Tensor) -> torch.Tensor:
    """Column order sorting each row by (-sim, id): best similarity
    first, ties toward the LOWER id (the flat search's first-wins compare
    when ids are the scan order). Two stable sorts: by id, then by -sim;
    equal (sim, id) pairs keep their column order."""
    id_order = torch.sort(ids, dim=-1, stable=True).indices
    sims_by_id = torch.gather(sims, -1, id_order)
    sim_order = torch.sort(-sims_by_id, dim=-1, stable=True).indices
    return torch.gather(id_order, -1, sim_order)


def _topk_by_id(sims: torch.Tensor, k: int,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    ids = torch.arange(sims.shape[-1], dtype=torch.int32,
                       device=sims.device).expand(sims.shape)
    order = _rank_by_sim_then_id(sims, ids)[:, :k]
    return order.to(torch.int32), torch.gather(sims, -1, order)


def am_shortlist(q_packed: torch.Tensor, super_packed_t: torch.Tensor,
                 n_dims: int, s: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse pass of the hierarchical search: the top-``s`` clusters.

    q_packed: (B, Dp) uint8; super_packed_t: (Dp, G) uint8 packed
    super-centroids; 1 <= s <= G. Returns ((B, s) int32 cluster ids,
    (B, s) float32 super similarities), best first, ties toward the lower
    cluster id."""
    sims = (n_dims - 2 * hamming_distances(q_packed, super_packed_t)).float()
    return _topk_by_id(sims, s)


def am_search_topk(q_packed: torch.Tensor, am_packed_t: torch.Tensor,
                   n_dims: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact flat top-k search (the recall reference): (idx, sims), each
    (B, min(k, C)), ordered by (-sim, centroid id); column 0 equals
    ``am_search_packed``."""
    sims = (n_dims - 2 * hamming_distances(q_packed, am_packed_t)).float()
    return _topk_by_id(sims, k)


def _popcount8(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each byte of a uint8 tensor (SWAR, stays uint8)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def am_search_sparse(q_packed: torch.Tensor, tiles_packed: torch.Tensor,
                     tile_ids: torch.Tensor, n_dims: int, k: int,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fine pass of the hierarchical search, on pre-gathered tiles.

    q_packed: (B, Dp) uint8; tiles_packed: (B, Dp, T*128) uint8, each
    query's shortlisted AM tiles side by side; tile_ids: (B, T*128) int32
    original centroid id of each column, -1 for padding and null-tile
    columns (masked). Returns ((B, k) int32 original ids, (B, k) float32
    sims) ordered by (-sim, id); slots with no candidate left are
    (-1, float32-min), also when k exceeds the column count. The
    (B, Dp, T*128) XOR stays uint8 until the reduce.
    """
    x = torch.bitwise_xor(q_packed[:, :, None], tiles_packed)
    ham = _popcount8(x).sum(dim=1, dtype=torch.int32)  # (B, T*128)
    valid = tile_ids >= 0
    sims = torch.where(valid, (n_dims - 2 * ham).float(),
                       torch.tensor(NEG, device=ham.device))
    ids = torch.where(valid, tile_ids,
                      torch.tensor(_SENT, dtype=tile_ids.dtype,
                                   device=ham.device))
    order = _rank_by_sim_then_id(sims, ids)[:, :k]
    top_sims = torch.gather(sims, -1, order)
    top_ids = torch.gather(tile_ids, -1, order)
    idx = torch.where(top_sims > NEG, top_ids, -1).to(torch.int32)
    pad = k - idx.shape[-1]
    if pad > 0:  # k > candidate columns: exhausted slots
        idx = F.pad(idx, (0, pad), value=-1)
        top_sims = F.pad(top_sims, (0, pad), value=NEG)
    return idx, top_sims


def encode_pack(feats: torch.Tensor, projection: torch.Tensor,
                ) -> torch.Tensor:
    """Feature -> packed query: H = feats @ projection in float32, bit 1
    iff H >= 0 (sign(0) -> +1), packed LSB-first along D with tail bits 0.
    (B, f), (f, D) -> (B, ceil(D/8)) uint8."""
    h = binary_mvm(feats, projection)
    return pack_rows(torch.where(h >= 0, 1.0, -1.0))


def predict_from_features(feats: torch.Tensor, projection: torch.Tensor,
                          am_packed_t: torch.Tensor,
                          centroid_class: torch.Tensor) -> torch.Tensor:
    """encode_pack + packed search + ownership gather -> (B,) classes."""
    qp = encode_pack(feats, projection)
    idx, _ = am_search_packed(qp, am_packed_t, projection.shape[1])
    return centroid_class[idx.long()]


def am_search(q: torch.Tensor, am_t: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused associative search: q (B, D) @ am_t (D, C) in float32, then
    (best_idx int32, best_sim f32), first-wins on ties."""
    sims = q.float() @ am_t.float()
    best_sim, best_idx = sims.max(dim=-1)
    return best_idx.to(torch.int32), best_sim


def unpack_rows(packed: torch.Tensor, n_dims: int) -> torch.Tensor:
    """(R, Dp) uint8 -> (R, Dp*8) float32: +1 / -1 for dims < n_dims and
    0 beyond, so a dot over the unpacked rows equals the bipolar dot over
    the first n_dims dims."""
    x = unpack_bits(packed)
    valid = torch.arange(x.shape[1], device=x.device) < n_dims
    return torch.where(valid, x, 0.0)


def am_search_packed_unpack(q_packed: torch.Tensor,
                            am_packed_t: torch.Tensor, n_dims: int,
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``mode="unpack"``: both packed operands unpacked to ±1 (0 past
    n_dims) and searched by the float dot — the same (idx, sim) as the
    popcount mode."""
    return am_search(unpack_rows(q_packed, n_dims),
                     unpack_rows(am_packed_t.T, n_dims).T)


def qail_targets(q: torch.Tensor, am_t: torch.Tensor,
                 centroid_class: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """QAIL steps 1-2 for one minibatch: (pred_t, true_t, mis).

    pred_t: Eq. (4), the global first-wins argmax of q @ am_t; true_t:
    Eq. (5), the argmax with every centroid the label does not own masked
    to float32-min (0 when the label owns none); mis: (B,) float32, 1
    where the predicted centroid's class is not the label, times mask.
    """
    sims = q.float() @ am_t.float()  # (B, C)
    pred_t = torch.argmax(sims, dim=-1)
    mis = (centroid_class[pred_t] != labels).float() * mask
    neg = torch.tensor(torch.finfo(sims.dtype).min, device=sims.device)
    own = centroid_class[None, :] == labels[:, None]
    true_t = torch.argmax(torch.where(own, sims, neg), dim=-1)
    return pred_t, true_t, mis


def qail_update_delta(q: torch.Tensor, upd: torch.Tensor,
                      am_t: torch.Tensor, centroid_class: torch.Tensor,
                      labels: torch.Tensor, mask: torch.Tensor, lr: float,
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused QAIL inner step (§III-C steps 1-3) for one minibatch.

    q, upd: (B, D); am_t: (D, C) transposed binary AM; centroid_class:
    (C,); labels: (B,) (-1 for padded rows); mask: (B,) {0, 1}. Returns
    (delta (C, D) float32, n_miss float32 scalar) with delta = W^T @ upd,
    W[i] = lr*mis_i*(onehot(true_t_i) - onehot(pred_t_i)).
    """
    pred_t, true_t, mis = qail_targets(q, am_t, centroid_class, labels,
                                       mask)
    return qail_delta(upd, pred_t, true_t, mis, lr, am_t.shape[1])


def qail_delta(upd: torch.Tensor, pred_t: torch.Tensor,
               true_t: torch.Tensor, mis: torch.Tensor, lr: float, c: int,
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """QAIL step 3 from the targets: (W^T @ upd, mis.sum())."""
    w = (lr * mis)[:, None] * (F.one_hot(true_t.long(), c).float()
                               - F.one_hot(pred_t.long(), c).float())
    return w.T @ upd.float(), mis.sum()


def adc_quantize(x: torch.Tensor, bits: int, clip: float) -> torch.Tensor:
    """Symmetric mid-tread ADC: clip to [-clip, +clip], then round to the
    nearest of the 2^bits + 1 codes ``step = 2*clip / 2**bits`` apart,
    ties to even (``torch.round``, as ``jnp.round``).

    ``step`` is a float32 tensor on ``x``'s device, so the division is a
    true IEEE division on every device (a Python-float divisor would be
    turned into a multiplication by its reciprocal on CUDA).
    """
    step = torch.tensor(2.0 * clip / (2 ** bits), dtype=torch.float32,
                        device=x.device)
    return torch.round(torch.clamp(x, -clip, clip) / step) * step


def imc_partials(q: torch.Tensor, am_t: torch.Tensor, tile_rows: int,
                 tile_cols: int, offsets: torch.Tensor | None = None,
                 ) -> torch.Tensor:
    """Pre-ADC analog partial sums of the tiled search: (B, gd, gc*tc),
    slot (b, g, c) = q[b, slab g] . am_t[slab g, c] + offsets[g, c // tc].
    Rows past D and columns past C are zero-padded.

    Each slab's dot is summed one row at a time, r = 0, 1, ..., as the
    kernels sum it: over bipolar queries every product is exact, so the
    partial sums are bit-equal to the kernels' even on a float
    (noise-perturbed) AM, where a matmul's other summation order could
    move a partial across an ADC rounding boundary.
    """
    b, d = q.shape
    d2, c = am_t.shape
    if d != d2:
        raise ValueError(f"widths differ: {tuple(q.shape)} vs "
                         f"{tuple(am_t.shape)}")
    gd, gc = -(-d // tile_rows), -(-c // tile_cols)
    qr = F.pad(q.float(), (0, gd * tile_rows - d)).reshape(b, gd, tile_rows)
    ar = F.pad(am_t.float(), (0, gc * tile_cols - c, 0, gd * tile_rows - d)
               ).reshape(gd, tile_rows, gc * tile_cols)
    part = torch.zeros((b, gd, gc * tile_cols), device=q.device)
    for r in range(tile_rows):
        part = part + qr[:, :, r, None] * ar[None, :, r, :]
    if offsets is not None:
        part = part + torch.repeat_interleave(offsets.float(), tile_cols,
                                              dim=1)[None]
    return part


def imc_sims(part: torch.Tensor, n_cols: int, adc_bits: int,
             adc_clip: float) -> torch.Tensor:
    """ADC every tile output of ``part`` (B, gd, >= C), then accumulate the
    row tiles in order g = 0, 1, ... (as the kernels do): (B, C)."""
    q = adc_quantize(part, adc_bits, adc_clip)
    sims = torch.zeros_like(q[:, 0])
    for g in range(q.shape[1]):
        sims = sims + q[:, g]
    return sims[:, :n_cols]


def _argmax_first(sims: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    best_sim, best_idx = sims.max(dim=-1)
    return best_idx.to(torch.int32), best_sim


def am_search_imc(q: torch.Tensor, am_t: torch.Tensor, *, tile_rows: int,
                  tile_cols: int, adc_bits: int, adc_clip: float,
                  offsets: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tiled analog associative search (device-fidelity semantics).

    The (D, C) AM is split into (tile_rows x tile_cols) arrays; each
    array's analog partial sum picks up its readout offset, goes through
    the ADC (``adc_quantize``) and only then is accumulated across row
    tiles. First-wins argmax over the quantized similarities.
    q: (B, D); am_t: (D, C) (possibly perturbed) AM; offsets: optional
    (ceil(D/tile_rows), ceil(C/tile_cols)). Returns (best_idx, best_sim).
    """
    part = imc_partials(q, am_t, tile_rows, tile_cols, offsets)
    return _argmax_first(imc_sims(part, am_t.shape[1], adc_bits, adc_clip))


def multibit_adc_clip(cell_bits: int, tile_rows: int = 128) -> float:
    """Default ADC full scale for bit-sliced multi-bit readout: the next
    power of two at or above Qmax * tile_rows, Qmax = 2^(b-1) - 1, so
    the mid-tread step is a power of two."""
    qmax = 2 ** (cell_bits - 1) - 1
    bound = max(qmax * tile_rows, 1)
    return float(2 ** (bound - 1).bit_length())


def pack_planes(u: torch.Tensor, n_planes: int) -> torch.Tensor:
    """(C, D) unsigned integer codes -> (n_planes, ceil(D/8), C) uint8:
    plane p holds bit p of every code, packed 8 cells/byte LSB-first
    along D and transposed; D-tail bits pack as 0 (code 0)."""
    c, d = u.shape
    u = F.pad(u.to(torch.int32), (0, -d % 8))
    dp = u.shape[1] // 8
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=u.device)
    planes = [(((u >> p) & 1).reshape(c, dp, 8) * weights).sum(dim=-1)
              .to(torch.uint8).T for p in range(n_planes)]
    return torch.stack(planes).contiguous()


def unpack_planes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_planes``: (P, Dp, C) uint8 -> (Dp*8, C) int32
    offset codes (D-tail rows unpack to 0)."""
    n_planes, dp, c = planes.shape
    shifts = torch.arange(8, dtype=torch.int32, device=planes.device)
    bits = (planes.to(torch.int32)[:, :, None, :]
            >> shifts[None, None, :, None]) & 1          # (P, Dp, 8, C)
    weights = 2 ** torch.arange(n_planes, dtype=torch.int32,
                                device=planes.device)
    return (bits.reshape(n_planes, dp * 8, c)
            * weights[:, None, None]).sum(dim=0, dtype=torch.int32)


def am_search_multibit(q: torch.Tensor, am_planes_t: torch.Tensor, *,
                       cell_bits: int, tile_rows: int = 128,
                       tile_cols: int = 128, adc_bits: int = 16,
                       adc_clip: float | None = None,
                       offsets: torch.Tensor | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-sliced multi-bit associative search (code domain).

    The planes hold offset codes u = code + Qmax; the search recentres
    them and runs the ``am_search_imc`` pipeline over the integer codes,
    so with bipolar queries every similarity is an integer. D-tail cells
    read -Qmax, but the matching query rows are zero-padded, so they
    contribute nothing. q: (B, D); am_planes_t: (cell_bits, ceil(D/8),
    C) uint8. Returns (best_idx, best_sim) in the code domain.
    """
    if adc_clip is None:
        adc_clip = multibit_adc_clip(cell_bits, tile_rows)
    b, d = q.shape
    n_planes, dp, c = am_planes_t.shape
    if n_planes != cell_bits:
        raise ValueError(f"{n_planes} planes for cell_bits={cell_bits}")
    if not dp * 8 >= d > (dp - 1) * 8:
        raise ValueError(f"D={d} inconsistent with Dp={dp}")
    codes_t = (unpack_planes(am_planes_t) - (2 ** (cell_bits - 1) - 1)
               ).float()
    qp = F.pad(q.float(), (0, dp * 8 - d))
    part = imc_partials(qp, codes_t, tile_rows, tile_cols, offsets)
    return _argmax_first(imc_sims(part, c, adc_bits, adc_clip))


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, cache_len: torch.Tensor,
                 softcap: float | None = None, return_lse: bool = False):
    """One-token GQA attention over a length-masked KV cache, all in
    float32: the function of the TPU kernel ``flash_decode``.

    q: (B, H, Dh); k_cache/v_cache: (B, S, KV, Dh), H % KV == 0 (query
    head h reads KV head h // (H // KV)); cache_len: (B,) keys at index
    >= cache_len[b] are masked. A row with cache_len 0 yields 0 (the
    kernel's ``m_safe`` / ``corr`` guards). ``softcap``: the scaled
    scores s become softcap * tanh(s / softcap) before the mask (the
    reference's ``attention_decode``). P @ V runs in float32 on the
    unrounded probabilities. Returns (B, H, Dh) in q's dtype; with
    ``return_lse`` (out, lse): out unrounded in float32, and the rows'
    log-sum-exp of the (capped) scores, (B, H) float32, -inf for a row
    with cache_len 0 (a sequence shard past the row's length): the
    partials a sequence-parallel decode merges.
    """
    b, h, dh = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if h % kv:
        raise ValueError(f"H={h} is not a multiple of KV={kv}")
    qg = q.float().reshape(b, kv, h // kv, dh)
    sc = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        * (1.0 / dh ** 0.5)
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    valid = (torch.arange(s, device=q.device)[None, :]
             < cache_len.reshape(-1, 1).to(q.device))
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(sc), torch.exp(sc - m_safe),
                    torch.zeros_like(sc))
    acc = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    l = p.sum(dim=-1, keepdim=True)
    out = (acc / l.clamp_min(1e-20)).reshape(b, h, dh)
    if not return_lse:
        return out.to(q.dtype)
    return out, (m + torch.log(l)).reshape(b, h)


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              dt: torch.Tensor, da: torch.Tensor, state: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Mamba-2 SSD chunk for every (batch, head), in float32: a port
    of ``repro.kernels.ssd_chunk.ref_ssd_chunk``.

    x: (B, Q, H, P); b/c: (B, Q, H, N); dt/da: (B, Q, H) (da the per-step
    log-decay); state: (B, H, N, P) entering the chunk. Returns
    (y (B, Q, H, P) in x's dtype, new_state (B, H, N, P) float32).
    """
    q = x.shape[1]
    cum = torch.cumsum(da.float(), dim=1)                     # (B,Q,H)
    seg_total = cum[:, -1]                                    # (B,H)
    xdt = x.float() * dt.float()[..., None]
    b32, c32 = b.float(), c.float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    # The exponent is masked before the exp (the reference masks after
    # it): the same values, but above the diagonal cum_i - cum_j grows
    # with Q and overflows, and where's gradient 0 * inf would be NaN.
    decay = torch.exp(torch.where(mask, cum[:, :, None, :]
                                  - cum[:, None, :, :], float("-inf")))
    cb = torch.einsum("bqhn,bkhn->bqkh", c32, b32)
    y_intra = torch.einsum("bqkh,bkhp->bqhp", cb * decay, xdt)
    y_inter = torch.einsum("bqhn,bhnp->bqhp",
                           c32 * torch.exp(cum)[..., None], state.float())
    state_decay = torch.exp(seg_total[:, None, :] - cum)
    bx = torch.einsum("bqhn,bqhp->bhnp", b32 * state_decay[..., None], xdt)
    new_state = state.float() * torch.exp(seg_total)[..., None, None] + bx
    return (y_intra + y_inter).to(x.dtype), new_state
