"""K-means with a dot-similarity assignment metric (§III-A1).

Port of ``repro.core.kmeans``. Assignment is argmax_j <h_i, c_j/||c_j||>
(dot similarity against norm-equalized centroids); the update is the
mean of the assigned samples, and the *returned* centroids are the raw
cluster means. Empty clusters are re-seeded with the sample least
similar to its current centroid, keeping every AM column usable.

The random initial rows come from ``torch.multinomial`` without
replacement on an explicit generator (``jax.random.choice`` in the
reference; the streams differ, so parity tests pass ``init=``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def _l2_normalize(x: torch.Tensor, dim: int = -1,
                  eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def assign_dot(h: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """argmax dot-similarity assignment. h: (n, D), centroids: (K, D)."""
    return torch.argmax(h @ centroids.T, dim=-1)


def kmeans_dot(gen: Optional[torch.Generator], h: torch.Tensor,
               n_clusters: int, n_iters: int = 25,
               sample_weight: Optional[torch.Tensor] = None,
               init: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run dot-similarity K-means.

    Args:
      gen: generator for the initial centroid rows (unused with ``init``).
      h: (n, D) sample hypervectors (float).
      n_clusters: K.
      n_iters: Lloyd iterations (fixed count).
      sample_weight: optional (n,) non-negative weights.
      init: optional (K, D) initial centroids (normalized internally).

    Returns:
      (centroids, assignment): ((K, D) float32, (n,) int32).
    """
    n = h.shape[0]
    h = h.float()
    if sample_weight is None:
        sample_weight = torch.ones((n,), dtype=torch.float32,
                                   device=h.device)
    w = sample_weight.float()

    if init is not None:
        c = _l2_normalize(init.float())
    else:
        p = w / torch.clamp(w.sum(), min=1e-8)
        init_idx = torch.multinomial(p, n_clusters, replacement=False,
                                     generator=gen)
        c = _l2_normalize(h[init_idx])

    inf = torch.tensor(float("inf"), device=h.device)
    for _ in range(n_iters):
        sim = h @ _l2_normalize(c).T  # (n, K)
        a = torch.argmax(sim, dim=-1)
        one_hot = F.one_hot(a, n_clusters).float() * w[:, None]
        counts = one_hot.sum(dim=0)  # (K,)
        new_c = (one_hot.T @ h) / torch.clamp(counts, min=1e-8)[:, None]
        # Empty-cluster repair: re-seed with the most orphaned sample.
        own_sim = torch.gather(sim, 1, a[:, None])[:, 0]
        own_sim = torch.where(w > 0, own_sim, inf)
        worst = torch.argmin(own_sim)
        empty = counts < 0.5
        c = torch.where(empty[:, None], h[worst][None, :], new_c)
    a = assign_dot(h, _l2_normalize(c))
    return c, a.to(torch.int32)


def classwise_kmeans(gen: Optional[torch.Generator], h: torch.Tensor,
                     labels: torch.Tensor, n_classes: int,
                     clusters_per_class: List[int], n_iters: int = 25,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class K-means (§III-A1 "Classwise Clustering").

    Returns (centroids (C_total, D) float32, centroid_class (C_total,)
    int32) with C_total = sum(clusters_per_class).
    """
    cents, owners = [], []
    for c in range(n_classes):
        kc = int(clusters_per_class[c])
        if kc <= 0:
            continue
        hc = h[labels == c]
        if hc.shape[0] == 0:
            raise ValueError(f"class {c} has no samples to cluster")
        if hc.shape[0] < kc:
            # Fewer samples than requested clusters: tile samples.
            hc = hc.repeat(-(-kc // hc.shape[0]), 1)
        cc, _ = kmeans_dot(gen, hc, kc, n_iters)
        cents.append(cc)
        owners.append(torch.full((kc,), c, dtype=torch.int32,
                                 device=h.device))
    return torch.cat(cents, dim=0), torch.cat(owners, dim=0)
