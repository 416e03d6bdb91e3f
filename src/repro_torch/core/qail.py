"""Quantization-aware iterative learning (QAIL) — §III-C.

Port of the batched engine of ``repro.core.qail``. Per minibatch, every
sample is scored against the **binary** AM; on a misprediction, Eq. (4)
picks the globally most similar centroid (push away), Eq. (5) the true
class's most similar centroid (pull toward), and Eq. (6) moves both in
the **float** shadow AM by lr * H. Step 4 (per-centroid normalization,
re-binarization at the mean) runs every ``refresh_every`` batches.

Determinism: the Eq.-(6) scatter is written as one product
``W^T @ upd`` with W = lr*mis*(onehot(true) - onehot(pred)) — the
formulation of ``repro.kernels.ref.qail_update_delta`` — instead of
``index_add_``, whose float atomics on CUDA sum in a different order
from run to run. Two fits from the same seeds give the same AM.

Not ported yet: the Pallas ``qail_update`` route (``use_kernel=True``,
ROADMAP queue 2, item 6), the noise-aware ``sim`` hook (queue 1, item
9), the multi-bit ``cell_bits`` hook (item 10), the sequential and
host-loop epochs and ``fold_feedback`` (item 6).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import am as am_lib
from repro_torch.core.types import MemhdConfig

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


def qail_batch_step(fp: torch.Tensor, binary: torch.Tensor,
                    centroid_class: torch.Tensor, q: torch.Tensor,
                    upd: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor, lr: float,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One minibatch of QAIL steps 1-3: returns (new fp, miss count)."""
    c = binary.shape[0]
    sims = q @ binary.T  # (B, C)
    pred_t = torch.argmax(sims, dim=-1)  # Eq. (4)
    mis = (centroid_class[pred_t] != labels).float() * mask
    neg = torch.tensor(torch.finfo(sims.dtype).min, device=sims.device)
    own = centroid_class[None, :] == labels[:, None]
    true_t = torch.argmax(torch.where(own, sims, neg), dim=-1)  # Eq. (5)
    w = (lr * mis)[:, None] * (F.one_hot(true_t, c).float()
                               - F.one_hot(pred_t, c).float())  # (B, C)
    return fp + w.T @ upd.float(), mis.sum()  # Eq. (6)


def qail_epoch_scan(state: AmState, cfg: MemhdConfig,
                    hb: torch.Tensor, qb: torch.Tensor, yb: torch.Tensor,
                    mask: torch.Tensor, *, refresh_every: int = 1,
                    use_kernel: bool = False, sim=None, noise_key=None,
                    noise_mode: str = "fixed",
                    cell_bits: Optional[int] = None,
                    ) -> Tuple[AmState, torch.Tensor]:
    """One QAIL epoch over ``prebatch``ed minibatches.

    Step 4 runs every ``refresh_every`` batches; if the last batch did
    not refresh, the epoch ends with one finalize. Returns (state,
    n_miss) with n_miss a device scalar (pulling it is the caller's one
    host sync per epoch).
    """
    if use_kernel:
        raise NotImplementedError(
            "QAIL through the qail_update kernel is not ported yet "
            "(ROADMAP queue 2, item 6)")
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
                                   yb[b], mask[b], cfg.lr)
        misses = misses + miss
        if (b + 1) % refresh_every == 0:
            fp, binary = refresh_am(fp, binary, cfg)
    state = dict(state, fp=fp, binary=binary)
    if nb % refresh_every != 0:  # the last batch didn't refresh
        state = qail_finalize_epoch(state, cfg)
    return state, misses


def qail_epoch_sequential(*args, **kwargs):
    raise NotImplementedError(
        "the sample-by-sample QAIL epoch is not ported yet "
        "(ROADMAP queue 1, item 6)")


def qail_epoch_hostloop(*args, **kwargs):
    raise NotImplementedError(
        "the host-loop QAIL epoch is not ported yet (ROADMAP queue 1, item 6)")


def fold_feedback(*args, **kwargs):
    raise NotImplementedError(
        "fold_feedback is not ported yet (ROADMAP queue 1, item 6)")


def evaluate(state: AmState, queries: torch.Tensor, labels: torch.Tensor,
             batch: int = 4096) -> float:
    """Classification accuracy of the binary AM on (queries, labels)."""
    from repro_torch.core import evaluate as eval_lib
    return eval_lib.am_accuracy(state, queries, labels, batch=batch)
