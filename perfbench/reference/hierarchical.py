"""Reference of the coarse-to-fine artifact (``target="hierarchical"``).

Offline, the C columns are grouped into G clusters and each cluster gets a
majority-vote super-centroid. This is worked out again here from the
benchmark's AM, by a frozen copy of the clustering the deploy defines
(draws from a CPU ``torch.Generator(seed)``: a Lloyd subsample of
``kmeans_sample`` columns and a numpy seed; k-means++ seeding in numpy;
``kmeans_iters`` dot-similarity Lloyd steps on the subsample; two
refinement steps over every column; a full assignment, capped at
``balance_cap`` members a cluster with the spill re-homed to each
member's next-best cluster with room; the vote, +1 on a tie).

Online, a query's clusters are ranked by their super's similarity and the
best S kept (ties to the lower cluster id); the answer is the k best
columns among those clusters' members by (-similarity, column id), as
(classes, ids, similarities), a slot without a candidate (-1, -1, NEG).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference as ref

TILE = 128
CHUNK = 16384


def _round_up(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def balance_cap(n_cols: int, n_groups: int) -> int:
    """Members a cluster may keep: the mean size, a quarter more and a
    quarter tile, rounded up to whole tiles."""
    mean = -(-n_cols // max(n_groups, 1))
    return _round_up(max(mean, 1) + mean // 4 + TILE // 4, TILE)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def _kmeanspp(rng: np.random.Generator, x: np.ndarray, g: int) -> np.ndarray:
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)
    seeds = np.empty(g, np.int64)
    seeds[0] = rng.integers(x.shape[0])
    d2 = np.maximum(2.0 - 2.0 * (xn @ xn[seeds[0]]), 0.0)
    for j in range(1, g):
        total = d2.sum()
        if total <= 0:
            seeds[j:] = rng.integers(x.shape[0], size=g - j)
            break
        seeds[j] = rng.choice(x.shape[0], p=d2 / total)
        d2 = np.minimum(d2, np.maximum(2.0 - 2.0 * (xn @ xn[seeds[j]]),
                                       0.0))
    return seeds


def _lloyd(h: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Dot-similarity k-means from ``init``; an empty cluster takes the
    row least similar to its own centroid."""
    k = init.shape[0]
    cents = _normalize(init)
    for _ in range(iters):
        sim = h @ _normalize(cents).T
        a = torch.argmax(sim, dim=-1)
        one_hot = torch.nn.functional.one_hot(a, k).float()
        counts = one_hot.sum(dim=0)
        means = (one_hot.T @ h) / torch.clamp(counts, min=1e-8)[:, None]
        worst = torch.argmin(torch.gather(sim, 1, a[:, None])[:, 0])
        cents = torch.where((counts < 0.5)[:, None], h[worst][None, :],
                            means)
    return cents


def _blocks(am: torch.Tensor):
    for i in range(0, am.shape[0], CHUNK):
        yield i, am[i:i + CHUNK].float()


def _segment_sum(blk: torch.Tensor, a: torch.Tensor, g: int) -> torch.Tensor:
    out = torch.zeros((g,) + tuple(blk.shape[1:]), device=blk.device)
    return out.index_add_(0, a, blk)


def _balance(sims: np.ndarray, assign: np.ndarray, cap: int) -> np.ndarray:
    g = sims.shape[1]
    assign = assign.astype(np.int64).copy()
    counts = np.bincount(assign, minlength=g)
    for grp in np.nonzero(counts > cap)[0]:
        members = np.nonzero(assign == grp)[0]
        keep = np.argsort(-sims[members, grp], kind="stable")
        for i in members[keep[cap:]]:
            for alt in np.argsort(-sims[i], kind="stable"):
                if alt != grp and counts[alt] < cap:
                    assign[i] = alt
                    counts[alt] += 1
                    counts[grp] -= 1
                    break
    return assign


def cluster(seed: int, am: torch.Tensor, groups: int, iters: int,
            sample) -> tuple[torch.Tensor, torch.Tensor]:
    """((G, D) float32 ±1 supers, (C,) int64 cluster of each column)."""
    c = am.shape[0]
    dev = am.device
    gen = torch.Generator().manual_seed(int(seed))
    fit = am
    if sample is not None and sample < c:
        rows = torch.randperm(c, generator=gen)[:sample].numpy()
        fit = am[torch.as_tensor(rows.astype(np.int64), device=dev)]
    numpy_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    fit = fit.float()
    seeds = _kmeanspp(np.random.default_rng(numpy_seed), fit.cpu().numpy(),
                      groups)
    cents = _normalize(_lloyd(fit, fit[torch.as_tensor(seeds, device=dev)],
                              iters))
    for _ in range(2):
        sums = torch.zeros((groups, am.shape[1]), device=dev)
        cnts = torch.zeros((groups,), device=dev)
        for _, blk in _blocks(am):
            a = torch.argmax(blk @ cents.T, dim=-1)
            sums += _segment_sum(blk, a, groups)
            cnts += _segment_sum(torch.ones(blk.shape[0], device=dev), a,
                                 groups)
        cents = _normalize(torch.where(cnts[:, None] > 0, sums, cents))
    sims = np.concatenate([(blk @ cents.T).cpu().numpy()
                           for _, blk in _blocks(am)])
    assign = sims.argmax(axis=-1)
    if groups > 1:
        assign = _balance(sims, assign, balance_cap(c, groups))
    assign_t = torch.as_tensor(assign, device=dev)
    sums = torch.zeros((groups, am.shape[1]), device=dev)
    for i, blk in _blocks(am):
        sums += _segment_sum(blk, assign_t[i:i + blk.shape[0]], groups)
    return torch.where(sums >= 0, 1.0, -1.0), assign_t


def prepare(inputs, opts: dict, seed: int) -> dict:
    with ref.precision(False):
        supers, assign = cluster(seed, inputs.am, opts["groups"],
                                 opts["kmeans_iters"],
                                 opts["kmeans_sample"])
    return {"projection": inputs.projection, "am_t": inputs.am.T,
            "owners": inputs.owners, "supers_t": supers.T,
            "assign": assign, "shortlist": opts["shortlist"]}


def answers(state: dict, feats: torch.Tensor, route: dict,
            lower: bool = False) -> tuple[tuple, dict]:
    if route["call"] != "predict_topk":
        raise ValueError(f"hierarchical: no reference for "
                         f"{route['call']!r}")
    k = route["kwargs"]["k"]
    q = ref.queries(feats, state["projection"], lower)
    d = q.shape[1]
    groups = state["supers_t"].shape[1]
    every = torch.ones((1, groups), dtype=torch.bool, device=q.device)
    short, _ = ref.top_by_key(ref.matmul(q, state["supers_t"], lower),
                              every, state["shortlist"], d)
    chosen = torch.zeros((q.shape[0], groups), dtype=torch.bool,
                         device=q.device)
    chosen.scatter_(1, short.long(), True)
    cls, ids, sims, searched = [], [], [], 0
    touched = torch.zeros(state["am_t"].shape[1], dtype=torch.bool,
                          device=q.device)
    rows = max(1, (1 << 27) // state["am_t"].shape[1])
    for i in range(0, q.shape[0], rows):
        member = chosen[i:i + rows][:, state["assign"]]
        idx, best = ref.top_by_key(
            ref.matmul(q[i:i + rows], state["am_t"], lower), member, k, d)
        ids.append(idx)
        sims.append(best)
        cls.append(torch.where(idx >= 0,
                               state["owners"][idx.long().clamp_min(0)], -1))
        searched += int(member.sum())
        touched |= member.any(dim=0)
    work = {"groups": q.shape[0] * groups, "columns": searched,
            "columns_touched": int(touched.sum())}
    return (torch.cat(cls), torch.cat(ids), torch.cat(sims)), work
