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

Not ported yet: the noise-aware ``sim`` hook (ROADMAP queue 1, item 9),
the multi-bit ``cell_bits`` hook (item 10) and ``qail_batch_delta``, the
data-parallel delta (item 13).
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


def qail_batch_delta(*args, **kwargs):
    raise NotImplementedError(
        "the data-parallel QAIL delta is not ported yet "
        "(ROADMAP queue 1, item 13)")


def qail_epoch_scan(state: AmState, cfg: MemhdConfig,
                    hb: torch.Tensor, qb: torch.Tensor, yb: torch.Tensor,
                    mask: torch.Tensor, *, refresh_every: int = 1,
                    use_kernel: bool = False, sim=None, noise_key=None,
                    noise_mode: str = "fixed",
                    cell_bits: Optional[int] = None,
                    ) -> Tuple[AmState, torch.Tensor]:
    """One QAIL epoch over ``prebatch``ed minibatches.

    Step 4 runs every ``refresh_every`` batches; if the last batch did
    not refresh, the epoch ends with one finalize. ``use_kernel=True``
    runs each minibatch through the ``qail_update`` kernel and adds its
    delta, ``fp = fp + delta``. Returns (state, n_miss) with n_miss a
    device scalar (pulling it is the caller's one host sync per epoch).
    """
    if sim is not None or noise_key is not None:
        raise NotImplementedError(
            "noise-aware QAIL is not ported yet (ROADMAP queue 1, item 9)")
    if cell_bits is not None:
        raise NotImplementedError(
            "multi-bit QAT is not ported yet (ROADMAP queue 1, item 10)")
    if noise_mode not in ("fixed", "fresh"):
        raise ValueError(f"bad noise_mode: {noise_mode!r}")

    centroid_class = state["centroid_class"]
    fp, binary = state["fp"], state["binary"]
    nb = hb.shape[0]
    misses = torch.zeros((), device=fp.device)
    for b in range(nb):
        upd = hb[b] if cfg.update_with == "encoded" else qb[b]
        fp, miss = qail_batch_step(fp, binary, centroid_class, qb[b], upd,
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
