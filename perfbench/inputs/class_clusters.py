"""MNIST-shaped features and a class-wise clustered AM (the paper's §III-A1).

Features: the structure of the repo's synthetic MNIST (``data/hdc.py``),
drawn on the device: every class is a mixture of ``modes`` latent styles,
a style is a sparse template (a class-common part plus a style part) and
a row is its template plus Gaussian noise, squashed into [0, 1] by a
sigmoid and rounded down to the ``feature_bits`` grid.

AM: ``train_rows`` rows of the same distribution are encoded by the
projection (float32) and clustered class by class with dot-similarity
k-means (``kmeans_iters`` Lloyd steps from distinct random rows; an empty
cluster keeps its centroid). As in §III-A, each class first gets
``floor(columns * init_ratio / classes)`` centroids; the other columns go
to the classes in proportion to their training rows mispredicted by that
AM binarized at its global mean (one allocation round, the remainder one
column each to the worst classes), and the classes are clustered again
at those budgets. No QAIL epochs: the AM's values do not change the
serving work.
"""
from __future__ import annotations

import torch

from perfbench.inputs import Inputs, bipolar, dyadic


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def _kmeans(gen: torch.Generator, h: torch.Tensor, k: int,
            iters: int) -> torch.Tensor:
    """(k, D) dot-similarity centroids of the rows of ``h`` (repeated
    where it has fewer than k)."""
    h = h.repeat(-(-k // h.shape[0]), 1)
    pick = torch.randperm(h.shape[0], generator=gen, device=h.device)[:k]
    cents = h[pick]
    for _ in range(iters):
        a = torch.argmax(h @ _normalize(cents).T, dim=-1)
        sums = torch.zeros_like(cents).index_add_(0, a, h)
        counts = torch.bincount(a, minlength=k).float()
        cents = torch.where(counts[:, None] > 0,
                            sums / counts.clamp(min=1.0)[:, None], cents)
    return cents


def build(cfg: dict, gen: torch.Generator) -> Inputs:
    data = cfg["data"]
    f, d, c, k = cfg["features"], cfg["dim"], cfg["columns"], cfg["classes"]
    dev = gen.device
    projection = bipolar(gen, (f, d))

    def sparse_normal(shape, sigma, density):
        z = torch.randn(shape, generator=gen, device=dev) * sigma
        return z * (torch.rand(shape, generator=gen, device=dev) < density)

    m = data["modes"]
    templates = (sparse_normal((k, 1, f), *data["class_common"])
                 + sparse_normal((k, m, f), *data["mode_delta"]))

    def sample_labeled(n: int):
        labels = torch.randint(0, k, (n,), generator=gen, device=dev)
        modes = torch.randint(0, m, (n,), generator=gen, device=dev)
        noise = torch.randn((n, f), generator=gen, device=dev)
        x = torch.sigmoid(templates[labels, modes] + data["noise"] * noise)
        return dyadic(x, data["feature_bits"]), labels

    train, labels = sample_labeled(data["train_rows"])
    h = train @ projection
    q = torch.where(h >= 0, 1.0, -1.0)

    def cluster(budgets):
        fp_am = torch.cat([_kmeans(gen, h[labels == cls], n,
                                   data["kmeans_iters"])
                           for cls, n in enumerate(budgets)])
        owners = torch.cat([torch.full((n,), cls, dtype=torch.int32,
                                       device=dev)
                            for cls, n in enumerate(budgets)])
        return torch.where(fp_am > fp_am.mean(), 1.0, -1.0), owners

    budgets = [max(1, int(c * cfg["init_ratio"]) // k)] * k
    am, owners = cluster(budgets)
    spare = c - sum(budgets)
    if spare:
        wrong = owners[torch.argmax(q @ am.T, dim=-1)] != labels
        miss = torch.bincount(labels[wrong], minlength=k).double()
        share = (miss / miss.sum() if miss.sum() > 0
                 else torch.full((k,), 1.0 / k, dtype=torch.float64,
                                    device=dev))
        add = torch.floor(share * spare).long().tolist()
        for cls in torch.argsort(-miss, stable=True).tolist()[
                :spare - sum(add)]:
            add[cls] += 1
        am, owners = cluster([n + a for n, a in zip(budgets, add)])
    return Inputs(projection, am, owners,
                  lambda n: sample_labeled(n)[0])
