"""Clustering-based initialization of the multi-centroid AM (§III-A).

Port of ``repro.core.init``. Two phases, following the paper:

1. **Classwise clustering** — with ratio R, every class gets
   ``n = max(1, floor(C*R / k))`` initial centroids from per-class
   dot-similarity K-means over the encoded training hypervectors.
2. **Cluster allocation** — the remaining columns are handed out round
   by round to the classes with the most mispredictions under the
   *binarized* AM, re-clustering after each round, until every column
   is used.

The orchestration is host-side Python; the K-means and validation
passes run on the tensors' device.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import am as am_lib
from repro_torch.core.kmeans import classwise_kmeans
from repro_torch.core.types import MemhdConfig

log = logging.getLogger(__name__)


def confusion_matrix(pred: torch.Tensor, true: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(k, k) counts: rows = true class, cols = predicted class."""
    idx = true.long() * n_classes + pred.long()
    flat = torch.bincount(idx, minlength=n_classes * n_classes)
    return flat.reshape(n_classes, n_classes)


def misprediction_counts(conf: torch.Tensor) -> torch.Tensor:
    """Per-class misclassification counts (off-diagonal row sums)."""
    return conf.sum(dim=1) - torch.diagonal(conf)


def _allocate_round(mispred: np.ndarray, budgets: np.ndarray,
                    spare: int, max_per_class: np.ndarray) -> np.ndarray:
    """Distribute up to ``spare`` new columns proportionally to
    misprediction counts (at least the single worst class gets one).

    Classes already at their sample-count ceiling receive nothing (a
    centroid per sample is the useful maximum).
    """
    room = np.maximum(max_per_class - budgets, 0)
    weights = mispred.astype(np.float64) * (room > 0)
    if weights.sum() <= 0:
        # Nothing mispredicted (or no room): spread round-robin over rooms.
        order = np.argsort(-room)
        add = np.zeros_like(budgets)
        i = 0
        while spare > 0 and room.sum() > 0:
            c = order[i % len(order)]
            if room[c] > 0:
                add[c] += 1
                room[c] -= 1
                spare -= 1
            i += 1
        return add
    shares = weights / weights.sum()
    add = np.floor(shares * spare).astype(np.int64)
    add = np.minimum(add, room)
    # Hand out any remainder one by one to the worst offenders with room.
    rem = spare - int(add.sum())
    order = np.argsort(-weights)
    i = 0
    while rem > 0 and np.any(room - add > 0):
        c = order[i % len(order)]
        if room[c] - add[c] > 0 and weights[c] > 0:
            add[c] += 1
            rem -= 1
        i += 1
        if i > 10 * len(order):  # all weighted classes full; spill over
            weights = (room - add > 0).astype(np.float64)
            order = np.argsort(-weights)
            i = 0
    return add


def clustering_init(
    gen: torch.Generator,
    cfg: MemhdConfig,
    h_train: torch.Tensor,
    labels: torch.Tensor,
    *,
    queries: Optional[torch.Tensor] = None,
    alloc_rounds_cap: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, List[dict]]:
    """Build the initial (C, D) float AM per §III-A.

    Returns (fp_am, centroid_class, history); history logs each
    allocation round (budgets, training accuracy).
    """
    k, c_total = cfg.classes, cfg.columns
    if queries is None:
        queries = torch.where(h_train >= 0, 1.0, -1.0)

    labels_np = labels.cpu().numpy()
    max_per_class = np.asarray(
        [max(1, int((labels_np == c).sum())) for c in range(k)], np.int64)
    budgets = np.minimum(np.full((k,), cfg.initial_clusters_per_class,
                                 np.int64), max_per_class)
    # R=1.0 can still leave a remainder (floor division) — those columns
    # also go through the allocation loop, as do the C(1-R) reserved ones.
    spare = c_total - int(budgets.sum())

    history: List[dict] = []
    centroids, owners = classwise_kmeans(
        gen, h_train, labels, k, list(budgets), cfg.kmeans_iters)

    rounds = 0
    while spare > 0 and rounds < alloc_rounds_cap:
        rounds += 1
        # Validate with the *binarized* AM: allocation chases deployment
        # errors.
        binary = am_lib.binarize_am(centroids, cfg.threshold)
        preds = am_lib.predict(binary, owners, queries)
        conf = confusion_matrix(preds, labels, k)
        mispred = misprediction_counts(conf).cpu().numpy()
        acc = float(torch.diagonal(conf).sum()) / labels_np.shape[0]

        add = _allocate_round(mispred, budgets, spare, max_per_class)
        if add.sum() == 0:
            log.info("allocation saturated with %d spare columns", spare)
            break
        budgets = budgets + add
        spare = c_total - int(budgets.sum())
        history.append({
            "round": rounds,
            "train_acc": acc,
            "mispred": mispred.tolist(),
            "budgets": budgets.tolist(),
            "spare": spare,
        })
        # Full re-cluster keeps the centroid layout canonical.
        centroids, owners = classwise_kmeans(
            gen, h_train, labels, k, list(budgets), cfg.kmeans_iters)

    if spare > 0:
        # Degenerate corner (tiny datasets): hand leftovers to the class
        # with the largest budget by duplicating its centroids with jitter.
        log.warning("%d unallocated columns after cap; duplicating", spare)
        top = int(np.argmax(budgets))
        reps_idx = torch.nonzero(owners == top)[:, 0]
        extra = centroids[reps_idx[:spare] % len(reps_idx)]
        extra = extra + 1e-3 * torch.randn(
            extra.shape, generator=gen, device=gen.device)
        centroids = torch.cat([centroids, extra], dim=0)
        owners = torch.cat([owners, torch.full(
            (spare,), top, dtype=torch.int32, device=owners.device)])

    if centroids.shape != (c_total, cfg.dim):
        raise AssertionError(f"initial AM shape {tuple(centroids.shape)}")
    return centroids, owners, history


def random_sampling_init(gen, cfg, h_train, labels):
    raise NotImplementedError(
        "random-sampling AM init is not ported yet (ROADMAP queue 1, item 5)")
