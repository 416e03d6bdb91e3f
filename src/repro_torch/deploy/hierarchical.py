"""``target="hierarchical"``: coarse-to-fine top-k deployment backend.

Port of ``repro.deploy.hierarchical``. Freezes a trained MEMHD model into
a two-stage search artifact for huge label spaces (C in the 10^5 range,
where the flat packed scan's linear cost is the wrong algorithm):

* **offline** — ``cluster_am`` groups the trained AM's C binary centroids
  into G clusters with the dot-similarity K-means the model trains with
  (``core.kmeans.kmeans_dot``), capacity-balances the assignment and
  majority-votes a packed *super-centroid* per cluster; ``build_layout``
  permutes the packed AM so every cluster owns a contiguous run of
  128-column tiles of one slab, plus a trailing all-invalid null tile;
* **online** — the ``am_shortlist`` kernel scores the query against the G
  super-centroids and keeps the S best clusters, then the
  ``am_search_sparse`` kernel searches only those clusters' tiles, read
  through the layout, with an exact top-k epilogue.

``groups`` (G, default ~1.4*sqrt(C)) and ``shortlist`` (S, default G).
**S = G is the exact configuration**: every cluster is searched and the
k = 1 result equals the flat packed scan bit for bit; S < G buys
sublinear query cost at a recall cost.

Randomness: the reference draws a Lloyd subsample (when C > sample) and
the seed of the numpy k-means++ generator from a ``jax.random`` key,
which torch cannot reproduce. The port draws both from a
``torch.Generator(seed)``; ``draws=ClusterDraws(rows, numpy_seed)``
hands in other draws (the tests cross the reference's). Everything after
the Lloyd fit is integer-valued and held bit-exact given an assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import on_device, resolve_device
from repro_torch.deploy.base import DeployedArtifact
from repro_torch.deploy.padding import round_up
from repro_torch.deploy.registry import register_backend
from repro_torch.obs.trace import traced

TILE = 128  # packed-slab column tile (the am_search_packed contract)


# -- offline: clustering ------------------------------------------------------

def default_groups(n_cols: int) -> int:
    """G ~ 1.4*sqrt(C): sqrt balances G coarse scores against C/G fine
    columns per cluster; the 1.4x over-partitions the index (the
    standard IVF trick) so K-means prefers splitting natural clusters
    (benign: each shard's super still matches its prototype) over
    merging them (fatal for recall: a blended super ranks low for both
    constituent clusters' queries)."""
    return max(1, min(n_cols, int(round(1.4 * float(np.sqrt(n_cols))))))


def balance_cap(n_cols: int, n_groups: int) -> int:
    """Per-cluster member cap: the mean cluster size plus TILE/4 slack,
    rounded up to a whole number of tiles. The tile rounding keeps the
    ``max_tiles`` budget minimal — the sparse gather's width (and so
    its cost) is ``S * max_tiles`` tiles, so one oversized cluster
    taxes EVERY query. The slack keeps total capacity comfortably above
    C: with capacity == C exactly, balancing degenerates into a forced
    uniform partition, and every member spilled out of a coherent
    natural cluster lands in a FOREIGN cluster whose super never ranks
    for that member's queries — an unfixable recall hole. The 1.25x
    proportional slack lets an unsplit natural cluster (up to ~1.25x
    the mean under over-partitioned G) stay whole."""
    mean = -(-n_cols // max(n_groups, 1))
    return round_up(max(mean, 1) + mean // 4 + TILE // 4, TILE)


def _kmeanspp_seeds(rng: np.random.Generator, x: np.ndarray,
                    g: int) -> np.ndarray:
    """Classic D^2-weighted k-means++ seeding on L2-normalized rows.

    Bipolar rows all share one norm, so dot-sim K-means is spherical
    K-means and squared distance is an affine map of the dot
    similarity. Seeding matters here: random-row init loses ~1/e of
    well-separated clusters to seed collisions, and every lost cluster
    is a recall hole the shortlist can never see past.
    """
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-8)
    seeds = np.empty(g, np.int64)
    seeds[0] = rng.integers(x.shape[0])
    d2 = np.maximum(2.0 - 2.0 * (xn @ xn[seeds[0]]), 0.0)
    for j in range(1, g):
        total = d2.sum()
        if total <= 0:  # fewer distinct rows than seeds: reuse any row
            seeds[j:] = rng.integers(x.shape[0], size=g - j)
            break
        seeds[j] = rng.choice(x.shape[0], p=d2 / total)
        d2 = np.minimum(d2, np.maximum(2.0 - 2.0 * (xn @ xn[seeds[j]]),
                                       0.0))
    return seeds


def _balance_assignment(sims: np.ndarray, assign: np.ndarray,
                        cap: int) -> np.ndarray:
    """Cap every cluster at ``cap`` members.

    Overflowing clusters keep their ``cap`` most-similar members; the
    spilled tail re-homes to each member's next-best cluster with room
    (by coarse similarity, deterministic). Total capacity
    ``G * cap >= C`` by construction of ``balance_cap``, so every spill
    finds a home.
    """
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


@dataclasses.dataclass(frozen=True)
class ClusterDraws:
    """The random draws of ``cluster_am``: the Lloyd subsample's row
    indices (None: fit on every row) and the integer seed of the numpy
    k-means++ generator."""

    rows: Optional[np.ndarray]
    numpy_seed: int


def cluster_draws(seed: int, n_cols: int,
                  sample: Optional[int]) -> ClusterDraws:
    """The port's own draws from ``torch.Generator(seed)`` (on the CPU,
    so a seed gives the same clustering on every device): rows without
    replacement when ``sample < n_cols``, then the numpy seed."""
    gen = torch.Generator().manual_seed(int(seed))
    rows = None
    if sample is not None and sample < n_cols:
        rows = torch.randperm(n_cols, generator=gen)[:sample].numpy()
    numpy_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    return ClusterDraws(rows, numpy_seed)


def _blocks(binary_am, chunk: int, device):
    """(start, (rows, D) float32 block on ``device``) over the AM."""
    for i in range(0, binary_am.shape[0], chunk):
        yield i, on_device(binary_am[i:i + chunk], device).float()


def _segment_sum(blk: torch.Tensor, a: torch.Tensor,
                 n_groups: int) -> torch.Tensor:
    # Sums of ±1 rows (or of ones): integers, exact in float32 below 2^24
    # in any order, so index_add_'s atomics on CUDA are deterministic here
    # (unlike QAIL's float deltas).
    out = torch.zeros((n_groups,) + tuple(blk.shape[1:]), device=blk.device)
    return out.index_add_(0, a, blk)


def fit_centroids(binary_am, n_groups: int, draws: ClusterDraws, *,
                  n_iters: int = 8, chunk: int = 16384,
                  refine_iters: int = 2, device=None) -> torch.Tensor:
    """The float half of ``cluster_am``: k-means++ seeds, Lloyd on the
    subsample, full-set refinement. Returns the (G, D) L2-normalized
    centroids the final assignment is scored against."""
    from repro_torch.core import kmeans
    device = resolve_device(device)
    rows = binary_am
    if draws.rows is not None:
        sel = np.asarray(draws.rows, np.int64)
        rows = (binary_am[torch.as_tensor(sel, device=binary_am.device)]
                if isinstance(binary_am, torch.Tensor) else binary_am[sel])
    fit = on_device(rows, device).float()
    seeds = _kmeanspp_seeds(np.random.default_rng(draws.numpy_seed),
                            fit.cpu().numpy(), n_groups)
    cents, _ = kmeans.kmeans_dot(None, fit, n_groups, n_iters,
                                 init=fit[torch.as_tensor(seeds,
                                                          device=device)])
    cents_n = kmeans._l2_normalize(cents)
    # Full-set Lloyd refinement: a subsampled fit merges/misses thin
    # clusters once C >> sample, which costs shortlist recall directly.
    for _ in range(max(refine_iters, 0)):
        sums = torch.zeros((n_groups, binary_am.shape[1]), device=device)
        cnts = torch.zeros((n_groups,), device=device)
        for _, blk in _blocks(binary_am, chunk, device):
            a = kmeans.assign_dot(blk, cents_n)
            sums += _segment_sum(blk, a, n_groups)
            cnts += _segment_sum(torch.ones(blk.shape[0], device=device),
                                 a, n_groups)
        cents_n = kmeans._l2_normalize(
            torch.where(cnts[:, None] > 0, sums, cents_n))
    return cents_n


def cluster_am(seed: int, binary_am, n_groups: int, *, n_iters: int = 8,
               sample: Optional[int] = None, chunk: int = 16384,
               refine_iters: int = 2, balance: bool = True,
               draws: Optional[ClusterDraws] = None, device=None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster the trained AM's centroids into G super-centroids.

    binary_am: (C, D) bipolar centroid rows (a tensor or a numpy array,
    any dtype). Lloyd runs on at most ``sample`` rows; the final
    assignment is one full dot-similarity pass over all C rows in
    ``chunk``-row blocks. With ``balance`` every cluster is capped at
    ``balance_cap`` members (the spill goes to each member's next-best
    cluster with room); the majority-vote supers are computed on the
    final assignment. ``draws`` overrides the draws of ``seed``.

    Returns (super_binary, assignment): (G, D) float32 bipolar supers and
    (C,) int32 cluster per centroid, on ``device``.
    """
    device = resolve_device(device)
    c = binary_am.shape[0]
    if not 1 <= n_groups <= c:
        raise ValueError(f"n_groups={n_groups} outside [1, {c}]")
    draws = draws or cluster_draws(seed, c, sample)
    cents_n = fit_centroids(binary_am, n_groups, draws, n_iters=n_iters,
                            chunk=chunk, refine_iters=refine_iters,
                            device=device)
    # Full-set assignment; the (C, G) coarse sims stay on the host, where
    # the balancer re-homes spilled members by them. This is the one float
    # step: torch and XLA may sum blk @ cents_n.T in other orders.
    sims = np.concatenate([(blk @ cents_n.T).cpu().numpy()
                           for _, blk in _blocks(binary_am, chunk, device)])
    assignment = sims.argmax(axis=-1)
    if balance and n_groups > 1:
        assignment = _balance_assignment(sims, assignment,
                                         balance_cap(c, n_groups))
    assign_t = torch.as_tensor(assignment, device=device)
    sums = torch.zeros((n_groups, binary_am.shape[1]), device=device)
    for i, blk in _blocks(binary_am, chunk, device):
        sums += _segment_sum(blk, assign_t[i:i + blk.shape[0]], n_groups)
    super_binary = torch.where(sums >= 0, 1.0, -1.0)
    return super_binary, assign_t.to(torch.int32)


# -- offline: cluster-contiguous slab layout ----------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterLayout:
    """Cluster-contiguous permutation of the packed AM (host arrays).

    slab: (Dp, Ctot) uint8 — packed columns permuted so cluster g
      occupies tiles [tile_start[g], tile_start[g] + tile_count[g]);
      each cluster zero-padded to a whole number of 128-column tiles;
      the LAST tile is the all-invalid null tile.
    col_ids: (Ctot,) int32 — original centroid id of each slab column,
      -1 for padding / null-tile columns.
    """
    slab: np.ndarray
    col_ids: np.ndarray
    tile_start: np.ndarray  # (G,) int32
    tile_count: np.ndarray  # (G,) int32
    max_tiles: int          # static gather width: max(tile_count)

    @property
    def n_tiles(self) -> int:
        return self.slab.shape[1] // TILE

    @property
    def null_tile(self) -> int:
        return self.n_tiles - 1


def build_layout(am_packed_t, assignment, n_groups: int) -> ClusterLayout:
    """Permute the packed AM into the cluster-contiguous tile slab.

    am_packed_t: (Dp, C) uint8 packed AM (``pack_am``); assignment:
    (C,) cluster id per centroid in [0, n_groups). Pure host-side
    numpy — runs once at deploy time.
    """
    apt = np.asarray(am_packed_t)
    assign = np.asarray(assignment, np.int64)
    c = assign.shape[0]
    if apt.shape[1] != c:
        raise ValueError(f"AM has {apt.shape[1]} columns, "
                         f"assignment covers {c}")
    if c and not (0 <= assign.min() and assign.max() < n_groups):
        raise ValueError("assignment out of range")

    # Permutation: sort centroids by (cluster, original id) — stable
    # within a cluster so the original scan order survives.
    order = np.lexsort((np.arange(c), assign))
    sizes = np.bincount(assign, minlength=n_groups)
    tile_count = np.array([round_up(int(s), TILE) // TILE for s in sizes],
                          np.int32)
    tile_start = np.concatenate(
        [[0], np.cumsum(tile_count)[:-1]]).astype(np.int32)
    n_tiles = int(tile_count.sum()) + 1  # + trailing null tile
    total = n_tiles * TILE

    col_ids = np.full(total, -1, np.int32)
    csum = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    offset = np.arange(c) - np.repeat(csum, sizes)
    dest = tile_start[assign[order]].astype(np.int64) * TILE + offset
    col_ids[dest] = order

    slab = np.zeros((apt.shape[0], total), np.uint8)
    slab[:, dest] = apt[:, order]
    max_tiles = int(tile_count.max()) if n_groups else 1
    return ClusterLayout(slab=slab, col_ids=col_ids,
                         tile_start=tile_start, tile_count=tile_count,
                         max_tiles=max_tiles)


def pack_rows_np(x) -> np.ndarray:
    """Host-side ``pack_rows``: (N, D) bipolar -> (N, ceil(D/8)) uint8.

    Same LSB-first layout and zero tail bits as ``kernels.pack_rows``;
    numpy so huge AMs pack without a float32 device copy.
    """
    bits = np.asarray(x) > 0
    return np.packbits(bits, axis=-1, bitorder="little")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the artifact -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierarchicalMemhd(DeployedArtifact):
    """Frozen coarse-to-fine serving artifact."""

    enc_params: Dict[str, torch.Tensor]
    super_packed_t: torch.Tensor   # (Dp, G) uint8 packed super-centroids
    am_slab_t: torch.Tensor        # (Dp, Ctot) uint8 cluster-contiguous slab
    col_ids: torch.Tensor          # (Ctot,) int32 original id per column
    tile_start: torch.Tensor       # (G,) int32
    tile_count: torch.Tensor       # (G,) int32
    centroid_class: torch.Tensor   # (C,) int32
    enc_cfg: Any
    am_cfg: Any
    groups: int = 1                # G
    shortlist: int = 1             # S; S == G is the exact configuration
    max_tiles: int = 1             # tiles searched per shortlisted cluster

    # -- inference -------------------------------------------------------------
    def search_query(self, q: torch.Tensor, k: int = 1,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, D) bipolar queries -> ((B, k) centroid ids, (B, k) sims):
        pack, shortlist S clusters against the super-AM, search their
        tiles. Ids are ORIGINAL centroid indices (pre-permutation)."""
        from repro_torch.kernels import ops
        qp = ops.pack_rows(q)
        short, _ = ops.am_shortlist(qp, self.super_packed_t,
                                    n_dims=self.am_cfg.dim,
                                    s=self.shortlist)
        return ops.am_search_sparse(
            qp, self.am_slab_t, self.col_ids, short, self.tile_start,
            self.tile_count, n_dims=self.am_cfg.dim, k=k,
            max_tiles=self.max_tiles)

    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) predicted class."""
        idx, _ = self.search_query(q, k=1)
        return self.centroid_class[idx[:, 0].long().clamp_min(0)]

    def topk_query(self, q: torch.Tensor, k: int,
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, D) queries -> ((B, k) classes, (B, k) ids, (B, k) sims);
        exhausted slots (fewer than k candidates in the shortlisted
        clusters) carry class -1 / id -1."""
        idx, sims = self.search_query(q, k=k)
        cls = torch.where(idx >= 0,
                          self.centroid_class[idx.long().clamp_min(0)], -1)
        return cls, idx, sims

    @traced("serve.predict_topk", batch_arg=1)
    def predict_topk(self, feats, k: int,
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, f) raw features -> top-k (classes, centroid ids, sims)."""
        from repro_torch.core import encoding
        feats = on_device(feats, self.device)
        q = encoding.encode_query(self.enc_params, self.enc_cfg, feats)
        return self.topk_query(q, k)

    # -- live updates ----------------------------------------------------------
    def refresh(self, model) -> "HierarchicalMemhd":
        """Re-freeze from an updated model.

        Same-C refresh keeps the layout: the frozen cluster assignment
        (``col_ids`` permutation and tile geometry) stays and only the
        resident bits are rewritten — slab values from the new binary AM,
        super-centroids re-voted under the frozen membership (an empty
        cluster's super becomes all +1). A changed C has no slot in the
        frozen layout and re-clusters through the registry.
        """
        binary = _host(model.am_state["binary"]).astype(np.float32)
        if binary.shape[0] != int(self.centroid_class.shape[0]):
            from repro_torch.deploy import registry
            return registry.deploy(model, self.backend,
                                   **self._deploy_opts())
        col_ids = _host(self.col_ids)
        packed = pack_rows_np(binary)  # (C, Dp)
        slab = np.zeros((packed.shape[1], col_ids.shape[0]), np.uint8)
        valid = col_ids >= 0
        slab[:, valid] = packed[col_ids[valid]].T

        tile_start = _host(self.tile_start)
        tile_count = _host(self.tile_count)
        supers = np.ones((self.groups, binary.shape[1]), np.float32)
        for g in range(self.groups):
            lo = int(tile_start[g]) * TILE
            members = col_ids[lo:lo + int(tile_count[g]) * TILE]
            members = members[members >= 0]
            if members.size:
                votes = binary[members].sum(axis=0)
                supers[g] = np.where(votes >= 0, 1.0, -1.0)
        dev = self.device
        return dataclasses.replace(
            self,
            enc_params=model.enc_params,
            super_packed_t=torch.as_tensor(pack_rows_np(supers).T.copy(),
                                           device=dev),
            am_slab_t=torch.as_tensor(slab, device=dev),
            centroid_class=model.am_state["centroid_class"],
            am_cfg=model.am_cfg)

    def _deploy_opts(self) -> dict:
        # Exact deployments (S == G) stay exact at the new C (both
        # default); a dialed-down shortlist keeps its absolute S.
        exact = self.shortlist == self.groups
        return {"groups": None, "shortlist": None if exact
                else self.shortlist}

    # -- reporting / accounting ------------------------------------------------
    @property
    def backend(self) -> str:
        return "hierarchical"

    @property
    def serving_mode(self) -> str:
        return f"coarse2fine-g{self.groups}-s{self.shortlist}"

    @property
    def resident_bytes(self) -> int:
        # Super-AM + permuted slab, both uint8; the layout index vectors
        # are small but resident, so they count too.
        return int(self.super_packed_t.numel() + self.am_slab_t.numel()
                   + self.col_ids.numel() * 4
                   + self.tile_start.numel() * 4
                   + self.tile_count.numel() * 4)


def artifact_from_layout(enc_params, super_packed_t, layout: ClusterLayout,
                         centroid_class, enc_cfg, am_cfg, *,
                         shortlist: Optional[int] = None,
                         device=None) -> HierarchicalMemhd:
    """The artifact from a layout (numpy or tensors) and packed supers;
    S defaults to G."""
    device = resolve_device(device)
    g = int(layout.tile_start.shape[0])
    s = g if shortlist is None else int(shortlist)
    if not 1 <= s <= g:
        raise ValueError(f"shortlist={s} outside [1, groups={g}]")

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(_host(x)), dtype=dtype,
                               device=device)

    return HierarchicalMemhd(
        enc_params={k: on_device(v, device) for k, v in enc_params.items()},
        super_packed_t=t(super_packed_t, torch.uint8),
        am_slab_t=t(layout.slab, torch.uint8),
        col_ids=t(layout.col_ids, torch.int32),
        tile_start=t(layout.tile_start, torch.int32),
        tile_count=t(layout.tile_count, torch.int32),
        centroid_class=t(centroid_class, torch.int32),
        enc_cfg=enc_cfg, am_cfg=am_cfg, groups=g, shortlist=s,
        max_tiles=int(layout.max_tiles))


# -- registry factory ---------------------------------------------------------

def build_search_state(seed: int, binary_am, n_groups: int, *,
                       kmeans_iters: int = 8,
                       kmeans_sample: Optional[int] = 16384,
                       draws: Optional[ClusterDraws] = None, device=None,
                       ) -> Tuple[torch.Tensor, ClusterLayout]:
    """Cluster + pack + lay out a bare (C, D) binary AM: the offline half
    of the backend, for driving the two kernels without a trained model.
    Returns ((Dp, G) uint8 packed supers on ``device``, the host-side
    ``ClusterLayout``)."""
    device = resolve_device(device)
    super_binary, assignment = cluster_am(
        seed, binary_am, n_groups, n_iters=kmeans_iters,
        sample=kmeans_sample, draws=draws, device=device)
    layout = build_layout(pack_rows_np(_host(binary_am)).T,
                          assignment.cpu().numpy(), n_groups)
    supers = pack_rows_np(super_binary.cpu().numpy()).T.copy()
    return torch.as_tensor(supers, device=device), layout


@register_backend("hierarchical")
def deploy_hierarchical(model, *, groups: Optional[int] = None,
                        shortlist: Optional[int] = None,
                        kmeans_iters: int = 8,
                        kmeans_sample: Optional[int] = 16384,
                        seed: int = 0,
                        draws: Optional[ClusterDraws] = None,
                        ) -> HierarchicalMemhd:
    """Cluster the trained AM and freeze the coarse-to-fine artifact.

    groups: G super-centroids (default ~1.4*sqrt(C)); shortlist: S
    clusters searched per query (default G — exact, equal to the flat
    scan; lower S for sublinear cost); kmeans_sample: Lloyd fits on at
    most this many centroids (the assignment always covers all);
    seed / draws: the clustering's random draws (``cluster_am``).
    """
    binary = model.am_state["binary"]
    c = int(binary.shape[0])
    g = default_groups(c) if groups is None else int(groups)
    s = g if shortlist is None else int(shortlist)
    if not 1 <= s <= g:
        raise ValueError(f"shortlist={s} outside [1, groups={g}]")
    supers, layout = build_search_state(
        seed, binary, g, kmeans_iters=kmeans_iters,
        kmeans_sample=kmeans_sample, draws=draws, device=binary.device)
    return artifact_from_layout(
        model.enc_params, supers, layout, model.am_state["centroid_class"],
        model.enc_cfg, model.am_cfg, shortlist=s, device=binary.device)
