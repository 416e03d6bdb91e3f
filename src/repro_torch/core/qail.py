"""Quantization-aware iterative learning (QAIL) — §III-C.

Port of ``repro.core.qail``. Per sample, the binarized query is scored
against the **binary** AM; on a misprediction, Eq. (4) picks the
globally most similar centroid (push away), Eq. (5) the true class's
most similar centroid (pull toward), and Eq. (6) moves both in the
**float** shadow AM by lr * H. Step 4 (per-centroid normalization,
re-binarization at the mean) follows.

Engines, as in the reference:

* ``qail_epoch_sequential`` — exact paper semantics, one sample at a
  time against the epoch's binary AM, step 4 once per epoch.
* ``qail_epoch_scan`` — the training engine over ``prebatch``ed
  minibatches, step 4 every ``refresh_every`` batches; with
  ``use_kernel=True`` each minibatch is one ``qail_update`` CUDA kernel
  (``kernels.ops.qail_update``). ``qail_epoch_batched`` and
  ``fold_feedback`` wrap it.
* ``qail_epoch_hostloop`` — the per-batch host loop, kept as the
  reference keeps it: a semantics oracle for the scan engine.

Determinism: the minibatch Eq.-(6) update is the product ``W^T @ upd``
with W = lr*mis*(onehot(true) - onehot(pred)) — the formulation of
``kernels.ref.qail_update_delta`` — or the ``qail_update`` kernel, which
sums each delta element in row order; never ``index_add_``, whose float
atomics on CUDA sum in a different order from run to run. The
sequential engine adds one row at a time, in sample order. Two fits from
the same seeds give the same AM.

``qail_epoch_scan`` carries the reference's two hooks: ``sim`` (noise-
aware QAIL: the sims MVM sees a device-perturbed view of the binary AM,
``repro_torch.imcsim``) and ``cell_bits`` (multi-bit QAT: it sees the
``cell_bits``-bit quantized view of the live float shadow).

``qail_batch_delta`` is the data-parallel delta (``core.distributed``):
it returns the batch's Eq.-(6) increment in a wire dtype instead of
adding it, so that shards can sum their deltas first.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import am as am_lib
from repro_torch.core.types import MemhdConfig
from repro_torch.kernels import ref as kernel_ref

AmState = Dict[str, torch.Tensor]


def _normalize_fp(fp_am: torch.Tensor, mode: str) -> torch.Tensor:
    """§III-C step 4's normalization: every centroid rescaled to the mean
    centroid norm (norm equalization, not unit norm)."""
    if mode == "none":
        return fp_am
    if mode == "l2":
        norm = torch.linalg.vector_norm(fp_am, dim=-1, keepdim=True)
        return fp_am * (norm.mean() / torch.clamp(norm, min=1e-8))
    raise ValueError(f"bad normalize mode: {mode!r}")


def refresh_am(fp: torch.Tensor, binary: torch.Tensor, cfg: MemhdConfig,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 4 (normalize + re-binarize) on raw AM buffers."""
    del binary
    fp = _normalize_fp(fp, cfg.normalize)
    return fp, am_lib.binarize_am(fp, cfg.threshold)


def qail_finalize_epoch(state: AmState, cfg: MemhdConfig) -> AmState:
    """Step 4 for the batched variant."""
    fp, binary = refresh_am(state["fp"], state["binary"], cfg)
    return dict(state, fp=fp, binary=binary)


def prebatch(h: torch.Tensor, q: torch.Tensor, labels: torch.Tensor,
             batch_size: int):
    """Reshape an epoch's data into device-resident minibatches.

    Pads n up to a multiple of ``batch_size`` (padded samples carry label
    -1 and mask 0, so they never fire an update) and returns
    ``(hb, qb, yb, mask)`` shaped ``(n_batches, batch_size, ...)``.
    """
    n, d = h.shape
    nb = -(-n // batch_size)
    pad = nb * batch_size - n
    mask = torch.cat([torch.ones((n,), device=h.device),
                      torch.zeros((pad,), device=h.device)])
    hb = F.pad(h, (0, 0, 0, pad))
    qb = F.pad(q, (0, 0, 0, pad))
    yb = F.pad(labels.to(torch.int32), (0, pad), value=-1)
    return (hb.reshape(nb, batch_size, d), qb.reshape(nb, batch_size, d),
            yb.reshape(nb, batch_size), mask.reshape(nb, batch_size))


def select_update_targets(sims: torch.Tensor, centroid_class: torch.Tensor,
                          label, n_classes: int,
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Eqs. (4) and (5) for one query: (mispredicted, pred_target,
    true_target) from its (C,) similarities against the binary AM.
    pred_target is the global first-wins argmax; true_target the argmax
    within the label's centroids (0 when the label owns none)."""
    del n_classes
    pred_target = torch.argmax(sims)  # Eq. (4)
    mispredicted = centroid_class[pred_target] != label
    neg = torch.tensor(torch.finfo(sims.dtype).min, device=sims.device)
    own = centroid_class == label
    true_target = torch.argmax(torch.where(own, sims, neg))  # Eq. (5)
    return mispredicted, pred_target, true_target


def qail_epoch_sequential(state: AmState, cfg: MemhdConfig,
                          h: torch.Tensor, queries: torch.Tensor,
                          labels: torch.Tensor) -> AmState:
    """One exact (sample-by-sample) QAIL epoch.

    Every sample is scored against the epoch's binary AM, so the targets
    of all samples come from one (n, C) product; the Eq.-(6) updates are
    then applied one sample at a time, in order — true target first,
    then the predicted one — exactly as the reference's scan adds them.
    Step 4 runs once, at epoch end.
    """
    upd = h if cfg.update_with == "encoded" else queries
    pred_t, true_t, mis = kernel_ref.qail_targets(
        queries, state["binary"].T, state["centroid_class"],
        labels.to(torch.int32), torch.ones(labels.shape, device=h.device))
    fp = state["fp"].clone()
    lr = torch.tensor(cfg.lr, dtype=fp.dtype, device=fp.device)
    pred_t, true_t = pred_t.tolist(), true_t.tolist()
    # Rows that missed; the others add lr*0*u = 0 and change nothing.
    for i in torch.nonzero(mis).flatten().tolist():
        step = lr * upd[i]
        fp[true_t[i]] += step
        fp[pred_t[i]] += -step
    fp = _normalize_fp(fp, cfg.normalize)
    return dict(state, fp=fp, binary=am_lib.binarize_am(fp, cfg.threshold))


def qail_batch_step(fp: torch.Tensor, binary: torch.Tensor,
                    centroid_class: torch.Tensor, q: torch.Tensor,
                    upd: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, lr: float, *,
                    use_kernel: bool = False,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch of QAIL steps 1-3: returns (new fp, miss count).

    ``binary`` is the (C, D) AM the sims are scored against (the binary
    AM, or a hook's perturbed or quantized float view of it).
    ``use_kernel=True`` routes it through ``ops.qail_update`` (the CUDA
    kernel on a CUDA tensor); otherwise the plain one-hot product."""
    if use_kernel:
        from repro_torch.kernels import ops
        delta, miss = ops.qail_update(q, upd, binary.T, centroid_class,
                                      labels, mask, lr=lr)
    else:
        delta, miss = kernel_ref.qail_update_delta(
            q, upd, binary.T, centroid_class, labels, mask, lr)
    return fp + delta, miss  # Eq. (6)


def qail_batch_update(state: AmState, cfg: MemhdConfig, h: torch.Tensor,
                      queries: torch.Tensor, labels: torch.Tensor,
                      ) -> Tuple[AmState, torch.Tensor]:
    """Minibatched QAIL update (one batch, one binary-AM snapshot), no
    binary refresh: returns (state with the new fp, n_miss)."""
    upd = h if cfg.update_with == "encoded" else queries
    fp, miss = qail_batch_step(
        state["fp"], state["binary"], state["centroid_class"], queries,
        upd, labels.to(torch.int32),
        torch.ones(labels.shape, device=h.device), cfg.lr)
    return dict(state, fp=fp), miss


def _add_rows_in_order(acc: torch.Tensor, idx: torch.Tensor,
                       rows: torch.Tensor) -> None:
    """``acc[idx[i]] += rows[i]`` for i = 0, 1, ... in place, every add
    rounded to ``acc``'s dtype: the rows of one target are added in row
    order, one rank of repeats at a time (within a rank the targets are
    distinct, so no add races another)."""
    idx = idx.long()
    n = idx.numel()
    if n == 0:
        return
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    pos = torch.arange(n, device=idx.device)
    first = torch.ones(n, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - start
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        t = idx[sel]
        acc[t] = acc[t] + rows[sel]


def qail_batch_delta(state: AmState, cfg: MemhdConfig, h: torch.Tensor,
                     queries: torch.Tensor, labels: torch.Tensor,
                     wire_dtype=torch.bfloat16,
                     mask: Optional[torch.Tensor] = None, *,
                     use_kernel: Optional[bool] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq.-(6) update *delta* for a batch (no state mutation).

    Returns (delta, n_miss): delta shaped like the float AM, in
    ``wire_dtype`` (what shards sum), and the float32 count of
    mispredicted samples; ``mask`` (B,) zeroes padded samples.

    ``use_kernel`` None means the ``qail_update`` kernel on a CUDA tensor
    (``ops.qail_update``, the single-device kernel fit's int8 route; on a
    meta tensor its plain version through ``ops``' meta tier) and the
    plain version below on the CPU. The plain version is the reference's:
    each coefficient row lr * mis * upd is rounded to ``wire_dtype``, then
    accumulated in it, true targets first and then predicted ones, each in
    row order (no ``index_add_``, whose float atomics on CUDA sum in any
    order). The kernel route rounds each summed delta once instead of
    each term: the two agree wherever every partial sum is exact in
    ``wire_dtype`` (±1 payloads at a dyadic lr, at most 256 terms a cell
    in bfloat16), and otherwise within (m + 1) ulps of ``wire_dtype``
    times the sum of |terms| (m terms a cell).
    """
    centroid_class, binary = state["centroid_class"], state["binary"]
    upd = h if cfg.update_with == "encoded" else queries
    labels = labels.to(torch.int32)
    if mask is None:
        mask = torch.ones(labels.shape, device=queries.device)
    mask = mask.float()
    if use_kernel is None:
        # meta (the dry run): ops' meta tier, the kernel's plain version.
        use_kernel = queries.device.type in ("cuda", "meta")
    if use_kernel:
        from repro_torch.kernels import ops
        delta, n_miss = ops.qail_update(queries, upd, binary.T,
                                        centroid_class, labels, mask,
                                        lr=cfg.lr)
        return delta.to(wire_dtype), n_miss
    pred_t, true_t, mis = kernel_ref.qail_targets(
        queries, binary.T, centroid_class, labels, mask)
    coef = ((cfg.lr * mis)[:, None] * upd.float()).to(wire_dtype)
    delta = torch.zeros(state["fp"].shape, dtype=wire_dtype,
                        device=queries.device)
    # Rows that hit add lr * 0 * u = 0: they change nothing.
    hit = mis != 0
    _add_rows_in_order(delta, true_t[hit], coef[hit])
    _add_rows_in_order(delta, pred_t[hit], -coef[hit])
    return delta, mis.sum()


def _training_view(fp: torch.Tensor, binary: torch.Tensor, b: int, *,
                   cell_bits, noisy: bool, sim, key, fixed: bool,
                   sampler, cache: dict) -> torch.Tensor:
    """The AM batch ``b``'s sims MVM sees: the binary AM, or the
    ``cell_bits``-bit codes of the live float shadow; perturbed with the
    device fields of key ``key`` (fixed mode) or ``key + (b,)`` (fresh
    mode). Fixed-mode fields are drawn once and kept in ``cache``."""
    from repro_torch.imcsim import device as device_lib
    if cell_bits is not None:
        codes, _ = am_lib.quantize_am(fp, cell_bits)
        view = codes.float()
    else:
        view = binary
    if not noisy:
        return view
    bkey = key if fixed else key + (b,)
    if "fields" in cache:
        fields = cache["fields"]
    elif cell_bits is not None:
        # Code-domain conductance noise: sigma per level step, drawn
        # under the batch key itself (the reference's
        # conductance_noise(bkey, ...)); faults were refused.
        fields = (None, (sampler or device_lib.draw)(
            bkey, tuple(view.shape), "normal", view.device))
    else:
        fields = device_lib.draw_cells(bkey, view.shape, sim, view.device,
                                       sampler)
    if fixed:
        cache["fields"] = fields
    return device_lib.perturb_binary(view, *fields, sim)


def qail_epoch_scan(state: AmState, cfg: MemhdConfig,
                    hb: torch.Tensor, qb: torch.Tensor, yb: torch.Tensor,
                    mask: torch.Tensor, *, refresh_every: int = 1,
                    use_kernel: bool = False, sim=None, noise_key=None,
                    noise_mode: str = "fixed",
                    cell_bits: Optional[int] = None, sampler=None,
                    ) -> Tuple[AmState, torch.Tensor]:
    """One QAIL epoch over ``prebatch``ed minibatches.

    Step 4 runs every ``refresh_every`` batches; if the last batch did
    not refresh, the epoch ends with one finalize. ``use_kernel=True``
    runs each minibatch through the ``qail_update`` kernel and adds its
    delta, ``fp = fp + delta``.

    Hooks (as the reference's):
      sim: an ``ImcSimConfig`` — noise-aware QAIL. Each batch's sims MVM
        sees the binary AM perturbed with the sim's stuck-at faults and
        conductance noise (``imcsim.device.perturb_binary``); the Eq.-(6)
        update still lands on the clean float shadow. A sim with neither
        is refused (the hook would be a silent no-op).
      noise_key: the key (an int or a tuple of ints, see
        ``imcsim.device``) of the perturbation; required with a noisy
        sim. noise_mode "fixed": every batch sees the fields drawn under
        ``noise_key`` (one device instance); "fresh": batch b sees those
        of ``noise_key + (b,)``.
      cell_bits: 2..8 — multi-bit QAT: the sims MVM sees the
        ``cell_bits``-bit codes of the live float shadow
        (``am.quantize_am``, re-quantized per batch), plus code-domain
        conductance noise with a sim; stuck-at faults are refused.
      sampler: where the fields come from (default ``device.draw``); the
        parity tests hand in the reference's fields.

    Returns (state, n_miss) with n_miss a device scalar (pulling it is
    the caller's one host sync per epoch).
    """
    noisy = sim is not None and (sim.noise_sigma > 0.0
                                 or sim.fault_p0 > 0.0
                                 or sim.fault_p1 > 0.0)
    if sim is not None and not noisy:
        raise ValueError(
            "sim carries no conductance noise or stuck-at faults; the "
            "noise-aware hook would be a no-op (ADC/drift live in the "
            "readout path, not the training MVM) — pass sim=None or a "
            "sim with noise_sigma/fault_p0/fault_p1 > 0")
    if noisy and noise_key is None:
        raise ValueError("sim injects device noise: pass noise_key")
    if noise_mode not in ("fixed", "fresh"):
        raise ValueError(f"bad noise_mode: {noise_mode!r}")
    if cell_bits is not None:
        if not 2 <= cell_bits <= 8:
            raise ValueError(f"cell_bits={cell_bits} outside [2, 8]")
        if noisy and (sim.fault_p0 > 0.0 or sim.fault_p1 > 0.0):
            raise ValueError(
                "stuck-at faults are 1-bit storage semantics; the "
                "multibit QAT hook composes with conductance noise only")
    key = None
    if noisy:
        from repro_torch.imcsim import device as device_lib
        key = device_lib.as_key(noise_key)

    centroid_class = state["centroid_class"]
    fp, binary = state["fp"], state["binary"]
    nb = hb.shape[0]
    misses = torch.zeros((), device=fp.device)
    cache: dict = {}
    for b in range(nb):
        upd = hb[b] if cfg.update_with == "encoded" else qb[b]
        view = binary
        if cell_bits is not None or noisy:
            view = _training_view(fp, binary, b, cell_bits=cell_bits,
                                  noisy=noisy, sim=sim, key=key,
                                  fixed=noise_mode == "fixed",
                                  sampler=sampler, cache=cache)
        fp, miss = qail_batch_step(fp, view, centroid_class, qb[b], upd,
                                   yb[b], mask[b], cfg.lr,
                                   use_kernel=use_kernel)
        misses = misses + miss
        if (b + 1) % refresh_every == 0:
            fp, binary = refresh_am(fp, binary, cfg)
    state = dict(state, fp=fp, binary=binary)
    if nb % refresh_every != 0:  # the last batch didn't refresh
        state = qail_finalize_epoch(state, cfg)
    return state, misses


def qail_epoch_batched(state: AmState, cfg: MemhdConfig, h: torch.Tensor,
                       queries: torch.Tensor, labels: torch.Tensor, *,
                       refresh_every: int = 1, use_kernel: bool = False,
                       ) -> Tuple[AmState, torch.Tensor]:
    """``prebatch`` + one ``qail_epoch_scan``: returns (state, miss rate)
    with the miss rate a device scalar."""
    n = h.shape[0]
    hb, qb, yb, mask = prebatch(h, queries, labels, cfg.batch_size)
    state, n_miss = qail_epoch_scan(state, cfg, hb, qb, yb, mask,
                                    refresh_every=refresh_every,
                                    use_kernel=use_kernel)
    return state, n_miss / n


def fold_feedback(state: AmState, cfg: MemhdConfig, h: torch.Tensor,
                  queries: torch.Tensor, labels: torch.Tensor, *,
                  epochs: int = 1, refresh_every: int = 1,
                  use_kernel: bool = False) -> Tuple[AmState, float]:
    """Fold a labeled feedback buffer into the AM: ``prebatch`` once and
    run ``epochs`` scan epochs over it (no init, no eval). Every label
    must own a centroid. Returns (new state, miss rate of the last
    epoch); the caller's ``state`` is not modified."""
    if epochs < 1:
        raise ValueError(f"epochs must be >= 1, got {epochs}")
    n = h.shape[0]
    hb, qb, yb, mask = prebatch(h, queries, labels, cfg.batch_size)
    n_miss = torch.zeros(())
    for _ in range(epochs):
        state, n_miss = qail_epoch_scan(state, cfg, hb, qb, yb, mask,
                                        refresh_every=refresh_every,
                                        use_kernel=use_kernel)
    return state, float(n_miss) / n


def qail_epoch_hostloop(state: AmState, cfg: MemhdConfig, h: torch.Tensor,
                        queries: torch.Tensor, labels: torch.Tensor, *,
                        refresh_every: int = 1) -> Tuple[AmState, float]:
    """The host-side epoch loop (one host sync per minibatch): the
    semantics oracle of ``qail_epoch_scan``, which it must match."""
    n = h.shape[0]
    bs = cfg.batch_size
    n_batches = -(-n // bs)
    total_miss = 0.0
    for b in range(n_batches):
        sl = slice(b * bs, min((b + 1) * bs, n))
        state, miss = qail_batch_update(state, cfg, h[sl], queries[sl],
                                        labels[sl])
        total_miss += float(miss)  # the per-batch host sync
        if (b + 1) % refresh_every == 0:
            state = qail_finalize_epoch(state, cfg)
    if n_batches % refresh_every != 0:
        state = qail_finalize_epoch(state, cfg)
    return state, total_miss / n


def evaluate(state: AmState, queries: torch.Tensor, labels: torch.Tensor,
             batch: int = 4096) -> float:
    """Classification accuracy of the binary AM on (queries, labels)."""
    from repro_torch.core import evaluate as eval_lib
    return eval_lib.am_accuracy(state, queries, labels, batch=batch)
