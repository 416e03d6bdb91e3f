"""The hierarchical coarse-to-fine backend: the port against the JAX
package on the CPU.

Operands come from numpy and feed both packages. Every similarity is an
integer, so the plain kernels (``am_shortlist``, ``am_search_topk``,
``am_search_sparse``, ``topk_select``) and the layout helpers are held
bit-exact against the reference's oracles and its Pallas kernels (in
interpret mode, the sparse kernel at T <= 3 tiles: its interpret mode
re-copies the gathered operand at every grid step).

``cluster_am`` draws a Lloyd subsample and a numpy seed from a
``jax.random`` key, which torch cannot reproduce, so the tests hand the
reference's draws to the port (``draws=``). Its one float step is the
dot-similarity assignment against float centroids, which torch and XLA
sum in different orders. The stated tolerance: a row's assignment must
match the reference's wherever its margin between the best and the
second-best cluster exceeds 2^-20 * D; everything downstream (balance,
layout, supers) is bit-exact given the assignment. A Lloyd step can meet
an exact tie (a row equally similar to two centroids: common when the
k-means++ seeds are bipolar rows and G exceeds the data's clusters), and
each framework's rounding then picks a side, after which the two fits
may part; the clustering tests therefore use planted, well-separated
clusters, where no step ties.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EncoderConfig, MemhdConfig, MemhdModel  # noqa: E402
from repro.core import am as jam  # noqa: E402
from repro.data import load_dataset as jax_load_dataset  # noqa: E402
from repro.deploy import hierarchical as jh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.am_search_sparse import (  # noqa: E402
    am_search_sparse_gathered as jax_sparse_gathered,
)
from repro.kernels.am_search_sparse import (  # noqa: E402
    expand_shortlist_tiles as jax_expand, gather_shortlist as jax_gather,
)
from repro.kernels.am_shortlist import am_shortlist as jax_shortlist  # noqa: E402
from repro.kernels.am_shortlist import topk_select as jax_topk_select  # noqa: E402
from repro.launch import serve_memhd as jserve  # noqa: E402
from repro_torch import convert, kernels  # noqa: E402
from repro_torch.deploy import hierarchical as th  # noqa: E402
from repro_torch.kernels import am_search_sparse as tsparse  # noqa: E402
from repro_torch.kernels import am_shortlist as tshort  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve_memhd as tserve  # noqa: E402

F = 64
# (batch, dim, groups): ragged bytes, a tail of bits, G = 1 and 2.
SHORT_GEOMS = [(1, 128, 1), (4, 100, 2), (3, 130, 45), (5, 8, 7),
               (2, 256, 23)]
# (batch, dim, columns, groups) of the sparse searches.
SPARSE_GEOMS = [(3, 128, 50, 7), (2, 100, 257, 3), (4, 8, 9, 1),
                (1, 256, 130, 2)]


def rng_for(*key):
    return np.random.default_rng([5151, *key])


def bipolar(rng, shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def packed(x):
    return n(jref.pack_rows(jnp.asarray(x)))


def same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def jax_draws(seed, c, sample):
    """The reference's draws for ``cluster_am(PRNGKey(seed), ...)``."""
    k_sub, k_fit = jax.random.split(jax.random.PRNGKey(seed))
    rows = None
    if sample is not None and sample < c:
        rows = np.asarray(jax.random.choice(k_sub, c, (sample,),
                                            replace=False))
    return th.ClusterDraws(rows, int(jax.random.randint(
        k_fit, (), 0, 2 ** 31 - 1)))


# -- plain kernels -------------------------------------------------------------

@pytest.mark.parametrize("b,d,g", SHORT_GEOMS)
def test_am_shortlist_matches_reference_and_pallas(b, d, g):
    rng = rng_for(1, b, d, g)
    sup = bipolar(rng, (g, d))
    sup[g // 2:] = sup[:g - g // 2]  # duplicated supers: forced ties
    qp, spt = packed(bipolar(rng, (b, d))), packed(sup).T
    for s in sorted({1, min(3, g), g}):
        want = jref.am_shortlist(jnp.asarray(qp), jnp.asarray(spt), d, s)
        same(ref.am_shortlist(t(qp), t(spt), d, s), want)
        same(tshort.am_shortlist(t(qp), t(spt), n_dims=d, s=s), want)
        same(ops.am_shortlist(t(qp), t(spt), n_dims=d, s=s), want)
        same(want, jax_shortlist(jnp.asarray(qp), jnp.asarray(spt),
                                 n_dims=d, s=s))


def test_shortlist_ties_break_to_lower_cluster_id():
    rng = rng_for(2)
    base = bipolar(rng, (4, 128))
    sup = np.concatenate([base, base])  # ids 0..3 == ids 4..7
    idx, sims = ref.am_shortlist(t(packed(bipolar(rng, (5, 128)))),
                                 t(packed(sup).T), 128, 8)
    idx, sims = n(idx), n(sims)
    for r in range(5):
        pos = {int(idx[r, a]): a for a in range(8)}
        for i in range(4):
            assert sims[r, pos[i]] == sims[r, pos[i + 4]]
            assert pos[i] < pos[i + 4]


@pytest.mark.parametrize("b,d,c,g", SPARSE_GEOMS)
def test_am_search_topk_matches_reference(b, d, c, g):
    rng = rng_for(3, b, d, c)
    am = bipolar(rng, (c, d))
    am[c // 2:] = am[:c - c // 2]
    qp, apt = packed(bipolar(rng, (b, d))), packed(am).T
    for k in (1, min(5, c), c + 2):
        same(ref.am_search_topk(t(qp), t(apt), d, k),
             jref.am_search_topk(jnp.asarray(qp), jnp.asarray(apt), d, k))
    first = ref.am_search_topk(t(qp), t(apt), d, 1)
    flat = ref.am_search_packed(t(qp), t(apt), d)
    assert torch.equal(first[0][:, 0], flat[0])
    assert torch.equal(first[1][:, 0], flat[1])


def _layout(rng, c, d, g):
    am = bipolar(rng, (c, d))
    am[c // 2:] = am[:c - c // 2]  # duplicated centroids: forced ties
    apt = packed(am).T
    return apt, jh.build_layout(apt, rng.integers(0, g, size=c), g)


@pytest.mark.parametrize("b,d,c,g", SPARSE_GEOMS)
def test_am_search_sparse_matches_reference(b, d, c, g):
    rng = rng_for(4, b, d, c, g)
    qp = packed(bipolar(rng, (b, d)))
    _, lay = _layout(rng, c, d, g)
    for s in sorted({1, min(2, g), g}):
        short = np.stack([rng.permutation(g)[:s] for _ in range(b)]
                         ).astype(np.int32)
        ja = [jnp.asarray(a) for a in (qp, lay.slab, lay.col_ids, short,
                                       lay.tile_start, lay.tile_count)]
        ta = [t(a) for a in (qp, lay.slab, lay.col_ids, short,
                             lay.tile_start, lay.tile_count)]
        tiles = tsparse.expand_shortlist_tiles(
            ta[3], ta[4], ta[5], max_tiles=lay.max_tiles,
            null_tile=lay.null_tile)
        jtiles = jax_expand(ja[3], ja[4], ja[5], max_tiles=lay.max_tiles,
                            null_tile=lay.null_tile)
        np.testing.assert_array_equal(n(tiles), np.asarray(jtiles))
        gathered, ids = tsparse.gather_shortlist(ta[1], ta[2], tiles)
        jg, jids = jax_gather(ja[1], ja[2], jtiles)
        same((gathered, ids), (jg, jids))
        for k in (1, 5, c + 2):  # c + 2: exhausted slots
            kw = dict(n_dims=d, k=k, max_tiles=lay.max_tiles)
            want = jops.am_search_sparse(*ja, use_kernel=False, **kw)
            same(ops.am_search_sparse(*ta, **kw), want)
            same(tsparse.am_search_sparse(*ta, **kw), want)
            same(tsparse.am_search_sparse_gathered(
                ta[0], gathered, ids, n_dims=d, k=k), want)
            if tiles.shape[1] <= 3:
                same(want, jax_sparse_gathered(ja[0], jg, jids, n_dims=d,
                                               k=k))


def test_sparse_ties_break_on_original_id():
    # Two clusters each hold one copy of every duplicated centroid; the
    # lower ORIGINAL id wins each tie although the layout scattered them.
    rng = rng_for(5)
    base = bipolar(rng, (6, 128))
    am = np.concatenate([base, base])  # ids 0..5 == ids 6..11
    lay = jh.build_layout(packed(am).T, np.array([0, 1] * 6), 2)
    short = np.tile(np.arange(2, dtype=np.int32), (4, 1))
    idx, sims = ops.am_search_sparse(
        t(packed(bipolar(rng, (4, 128)))), t(lay.slab), t(lay.col_ids),
        t(short), t(lay.tile_start), t(lay.tile_count), n_dims=128, k=12,
        max_tiles=lay.max_tiles)
    idx, sims = n(idx), n(sims)
    for r in range(4):
        pos = {int(idx[r, a]): a for a in range(12)}
        for i in range(6):
            assert sims[r, pos[i]] == sims[r, pos[i + 6]]
            assert pos[i] < pos[i + 6]


@pytest.mark.parametrize("k", [1, 3, 9])
def test_topk_select_matches_reference(k):
    rng = rng_for(6, k)
    sims = np.round(rng.normal(size=(4, 7)) * 2).astype(np.float32)
    sims[:, 3] = sims[:, 1]  # ties
    ids = np.stack([rng.permutation(7) for _ in range(4)]).astype(np.int32)
    same(tshort.topk_select(t(sims), t(ids), k),
         jax_topk_select(jnp.asarray(sims), jnp.asarray(ids), k))


def test_plain_wrappers_refuse_bad_operands_and_never_launch():
    q = torch.zeros((2, 16), dtype=torch.uint8)
    spt = torch.zeros((16, 5), dtype=torch.uint8)
    kernels.reset_launches()
    with pytest.raises(ValueError, match="shortlist"):
        tshort.am_shortlist(q, spt, n_dims=128, s=6)
    with pytest.raises(ValueError, match="shortlist"):
        tshort.am_shortlist(q, spt, n_dims=128, s=0)
    with pytest.raises(ValueError, match="n_dims"):
        tshort.am_shortlist(q, spt, n_dims=100, s=1)
    lay = jh.build_layout(np.zeros((16, 5), np.uint8), np.zeros(5), 1)
    args = [t(a) for a in (lay.slab, lay.col_ids, np.zeros((2, 1), np.int32),
                           lay.tile_start, lay.tile_count)]
    with pytest.raises(ValueError, match="k=0"):
        tsparse.am_search_sparse(q, *args, n_dims=128, k=0, max_tiles=1)
    with pytest.raises(ValueError, match="multiple"):
        tsparse.am_search_sparse_gathered(
            q, torch.zeros((2, 16, 100), dtype=torch.uint8),
            torch.zeros((2, 100), dtype=torch.int32), n_dims=128, k=1)
    tshort.am_shortlist(q, spt, n_dims=128, s=5)
    tsparse.am_search_sparse(q, *args, n_dims=128, k=7, max_tiles=1)
    launched = kernels.launches()
    assert all(launched[k] == 0 for k in ("am_shortlist", "am_search_sparse",
                                          "am_search_sparse_gathered"))


# -- offline: clustering and layout ---------------------------------------------

def test_default_groups_and_balance_cap_match():
    for c in (1, 2, 3, 45, 512, 1024, 4096, 100_000):
        assert th.default_groups(c) == jh.default_groups(c)
        for g in (1, 7, th.default_groups(c), c):
            assert th.balance_cap(c, g) == jh.balance_cap(c, g)


@pytest.mark.parametrize("c,g", [(64, 5), (300, 40), (10, 10)])
def test_kmeanspp_seeds_and_balance_are_bit_exact(c, g):
    rng = rng_for(7, c, g)
    x = bipolar(rng, (c, 32))
    x[c // 2:] = x[:c - c // 2]  # fewer distinct rows than seeds for g = c
    np.testing.assert_array_equal(
        th._kmeanspp_seeds(np.random.default_rng(11), x, g),
        jh._kmeanspp_seeds(np.random.default_rng(11), x, g))
    sims = np.round(rng.normal(size=(c, g)) * 4).astype(np.float32)
    assign = rng.choice(g, size=c, p=np.r_[0.7, np.full(g - 1, 0.3 / (g - 1))]
                        if g > 1 else None)
    cap = max(1, c // g + 1)
    np.testing.assert_array_equal(th._balance_assignment(sims, assign, cap),
                                  jh._balance_assignment(sims, assign, cap))


@pytest.mark.parametrize("c,g", [(50, 7), (300, 3), (9, 1), (257, 2)])
def test_build_layout_is_bit_exact(c, g):
    rng = rng_for(8, c, g)
    apt = packed(bipolar(rng, (c, 100))).T
    assign = rng.integers(0, g, size=c)
    got, want = th.build_layout(apt, assign, g), jh.build_layout(apt, assign,
                                                                 g)
    for f in ("slab", "col_ids", "tile_start", "tile_count"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert (got.max_tiles, got.null_tile) == (want.max_tiles, want.null_tile)
    x = bipolar(rng, (3, 13))
    np.testing.assert_array_equal(th.pack_rows_np(x), jh.pack_rows_np(x))


def planted(rng, c, d, n_protos, flip=0.03, skew=None):
    """Planted, well-separated clusters: prototypes with bit flips."""
    protos = bipolar(rng, (n_protos, d))
    am = protos[rng.choice(n_protos, size=c, p=skew)]
    return np.where(rng.random(am.shape) < flip, -am, am).astype(np.float32)


@pytest.mark.parametrize("c,d,g,sample,skew", [
    (512, 128, 16, None, None),
    (500, 64, 8, 300, None),          # Lloyd on a 300-row subsample
    (512, 128, 2, None, [0.8, 0.2]),  # the 410-row cluster spills (cap 384)
    (40, 32, 1, None, None),
])
def test_cluster_am_with_crossed_draws(c, d, g, sample, skew):
    rng = rng_for(10, c, g, 0)
    am = planted(rng, c, d, g, skew=skew)
    draws = jax_draws(3, c, sample)
    j_sup, j_assign = jh.cluster_am(jax.random.PRNGKey(3), am, g,
                                    sample=sample)
    t_sup, t_assign = th.cluster_am(0, t(am), g, sample=sample, draws=draws,
                                    device="cpu")
    # The stated tolerance: equal wherever the margin exceeds 2^-20 * D.
    cents = th.fit_centroids(t(am), g, draws, device="cpu")
    sims = np.sort((t(am) @ cents.T).numpy(), axis=1)
    margin = sims[:, -1] - sims[:, -2] if g > 1 else np.full(c, np.inf)
    clear = margin > 2.0 ** -20 * d
    np.testing.assert_array_equal(t_assign.numpy()[clear],
                                  np.asarray(j_assign)[clear])
    # Given the assignment, the supers and the layout are bit-exact.
    if np.array_equal(t_assign.numpy(), np.asarray(j_assign)):
        np.testing.assert_array_equal(t_sup.numpy(), np.asarray(j_sup))
    assert t_assign.dtype == torch.int32 and t_sup.dtype == torch.float32
    if skew:
        assert np.bincount(t_assign.numpy()).max() <= th.balance_cap(c, g)


def test_cluster_am_alone_is_seeded_and_refuses_bad_groups():
    rng = rng_for(11)
    am = planted(rng, 200, 64, 6)
    a = th.cluster_am(5, am, 6, sample=100, device="cpu")
    b = th.cluster_am(5, am, 6, sample=100, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    draws = th.cluster_draws(5, 200, 100)
    assert len(set(draws.rows.tolist())) == 100
    assert th.cluster_draws(5, 200, None).rows is None
    with pytest.raises(ValueError, match="n_groups"):
        th.cluster_am(0, am, 201, device="cpu")


# -- the artifact --------------------------------------------------------------

def _dyadic(x):
    return (np.round(np.asarray(x)[:, :F] * 256) / 256).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    ds = jax_load_dataset("mnist", train_per_class=30, test_per_class=10)
    tr_x, te_x = _dyadic(ds.train_x), _dyadic(ds.test_x)
    enc = EncoderConfig(kind="projection", features=F, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=1,
                      normalize="none", kmeans_iters=5, batch_size=64)
    jm = MemhdModel.create(jax.random.key(0), enc, amc)
    jm, _ = jm.initialize_am(jax.random.key(1), tr_x, np.asarray(ds.train_y))
    tm = _carry(jm)
    return dict(jm=jm, tm=tm, te_x=te_x, enc=enc, amc=amc)


def _carry(jm):
    return convert.model_from_numpy(
        {"projection": np.asarray(jm.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jm.am_state.items()},
        dataclasses.asdict(jm.enc_cfg), dataclasses.asdict(jm.am_cfg),
        device="cpu")


def _from_reference(jdep, shortlist=None):
    leaves = {k: np.asarray(getattr(jdep, k)) for k in (
        "super_packed_t", "am_slab_t", "col_ids", "tile_start", "tile_count",
        "centroid_class")}
    return convert.hierarchical_from_numpy(
        {"projection": np.asarray(jdep.enc_params["projection"])}, leaves,
        dataclasses.asdict(jdep.enc_cfg), dataclasses.asdict(jdep.am_cfg),
        shortlist=shortlist, device="cpu")


def _deploy_pair(pair, **opts):
    jdep = pair["jm"].deploy(target="hierarchical", **opts)
    tdep = pair["tm"].deploy(target="hierarchical",
                             draws=jax_draws(0, 128, 16384), **opts)
    return jdep, tdep


@pytest.mark.parametrize("groups", [None, 8, 30])
def test_deploy_matches_reference(pair, groups):
    jdep, tdep = _deploy_pair(pair, groups=groups)
    for f in ("super_packed_t", "am_slab_t", "col_ids", "tile_start",
              "tile_count", "centroid_class"):
        np.testing.assert_array_equal(n(getattr(tdep, f)),
                                      np.asarray(getattr(jdep, f)))
    assert (tdep.groups, tdep.shortlist, tdep.max_tiles) == (
        jdep.groups, jdep.shortlist, jdep.max_tiles)
    assert tdep.backend == jdep.backend == "hierarchical"
    assert tdep.serving_mode == jdep.serving_mode
    assert tdep.resident_bytes == jdep.resident_bytes
    assert tdep.am_memory_ratio == pytest.approx(jdep.am_memory_ratio)
    x = pair["te_x"]
    for k in (1, 4):
        same(tdep.predict_topk(x, k), jdep.predict_topk(x, k))
    np.testing.assert_array_equal(n(tdep.predict(x)),
                                  np.asarray(jdep.predict(x)))


@pytest.mark.parametrize("shortlist", [1, 3])
def test_dialed_down_shortlist_serves_like_the_reference(pair, shortlist):
    jdep = pair["jm"].deploy(target="hierarchical", shortlist=shortlist)
    tdep = _from_reference(jdep, shortlist=shortlist)
    assert tdep.serving_mode == jdep.serving_mode
    x = pair["te_x"]
    for k in (1, 3, 200):  # 200: more than the shortlisted columns
        same(tdep.predict_topk(x, k), jdep.predict_topk(x, k))
    assert tdep.score(x, np.zeros(len(x), np.int32)) == pytest.approx(
        jdep.score(x, np.zeros(len(x), np.int32)))


def test_exact_configuration_equals_the_flat_packed_predict(pair):
    tm, x = pair["tm"], pair["te_x"]
    tdep = tm.deploy(target="hierarchical")  # the port's own draws
    flat = tm.deploy(target="packed")
    np.testing.assert_array_equal(n(tdep.predict(x)), n(flat.predict(x)))
    cls, idx, sims = tdep.predict_topk(x, 5)
    q = ref.pack_rows(tm.encode_query(t(x)))
    w_idx, w_sims = ref.am_search_topk(q, flat.am_packed_t, 128, 5)
    assert torch.equal(idx, w_idx) and torch.equal(sims, w_sims)
    assert torch.equal(cls, tm.am_state["centroid_class"][w_idx.long()])
    with pytest.raises(ValueError, match="shortlist"):
        tm.deploy(target="hierarchical", groups=4, shortlist=5)


def _perturbed(jm, rng, columns=None):
    """A reference model whose float AM moved (and optionally lost its
    last centroids), as after a fold or a class change."""
    fp = np.asarray(jm.am_state["fp"])
    cc = np.asarray(jm.am_state["centroid_class"])
    fp = fp + rng.normal(0, 0.3, fp.shape).astype(np.float32)
    c = columns or fp.shape[0]
    state = jam.make_am_state(jnp.asarray(fp[:c]), jnp.asarray(cc[:c]),
                              jm.am_cfg.threshold)
    return dataclasses.replace(
        jm, am_state=state,
        am_cfg=dataclasses.replace(jm.am_cfg, columns=c))


@pytest.mark.parametrize("shortlist", [None, 3])
def test_refresh_same_c_keeps_the_layout(pair, shortlist):
    jdep = pair["jm"].deploy(target="hierarchical", shortlist=shortlist)
    tdep = _from_reference(jdep, shortlist=shortlist)
    jm2 = _perturbed(pair["jm"], rng_for(12))
    jnew, tnew = jdep.refresh(jm2), tdep.refresh(_carry(jm2))
    for f in ("super_packed_t", "am_slab_t", "col_ids", "tile_start",
              "tile_count", "centroid_class"):
        np.testing.assert_array_equal(n(getattr(tnew, f)),
                                      np.asarray(getattr(jnew, f)))
    assert tnew.serving_mode == jnew.serving_mode
    same(tnew.predict_topk(pair["te_x"], 3),
         jnew.predict_topk(pair["te_x"], 3))


@pytest.mark.parametrize("shortlist", [None, 3])
def test_refresh_changed_c_reclusters(pair, shortlist):
    jdep = pair["jm"].deploy(target="hierarchical", shortlist=shortlist)
    tdep = _from_reference(jdep, shortlist=shortlist)
    jm3 = _perturbed(pair["jm"], rng_for(13), columns=96)
    jnew, tnew = jdep.refresh(jm3), tdep.refresh(_carry(jm3))
    assert (tnew.groups, tnew.shortlist) == (jnew.groups, jnew.shortlist)
    assert tnew.centroid_class.shape == (96,)
    if shortlist is None:  # exact at the new C: equal whatever the clusters
        same(tnew.predict_topk(pair["te_x"], 3),
             jnew.predict_topk(pair["te_x"], 3))


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("shortlist", [None, 2])
def test_topk_serving_matches_reference(pair, shortlist):
    jdep = pair["jm"].deploy(target="hierarchical", shortlist=shortlist)
    tdep = _from_reference(jdep, shortlist=shortlist)
    x = pair["te_x"]
    got, stats = tserve.serve_batches(
        tdep, tserve.synthetic_requests(x, 13, 9, seed=4), max_batch=24,
        depth=2, topk=3)
    want, _ = jserve.serve_batches(
        jdep, jserve.synthetic_requests(x, 13, 9, seed=4), max_batch=24,
        depth=2, topk=3)
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid].shape == (want[rid].shape[0], 3)
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    reqs = tserve.synthetic_requests(x, 13, 9, seed=4)
    rep = tserve.build_report(tdep, reqs, stats, 0.1, topk=3)
    jrep = jserve.build_report(jdep, reqs, stats, 0.1, topk=3)
    assert rep["topk"] == jrep["topk"] == 3
    for key in ("backend", "mode", "resident_am_bytes", "am_memory_ratio",
                "geometry"):
        assert rep[key] == jrep[key], key


def test_topk_serving_refusals(pair):
    tdep = pair["tm"].deploy(target="hierarchical")
    reqs = tserve.synthetic_requests(pair["te_x"], 3, 4)
    with pytest.raises(ValueError, match="topk"):
        tserve.serve_batches(tdep, reqs, topk=2, fused=True)
    with pytest.raises(AttributeError, match="predict_topk"):
        tserve.serve_batches(pair["tm"].deploy(target="packed"), reqs,
                             topk=2)
    argmax, _ = tserve.serve_batches(tdep, reqs)
    top, _ = tserve.serve_batches(tdep, reqs, topk=2)
    for rid in argmax:
        np.testing.assert_array_equal(top[rid][:, 0], argmax[rid])


@pytest.mark.parametrize("argv,mode", [
    (["--topk", "4"], "coarse2fine-g16-s16"),
    (["--shortlist", "4", "--groups", "12"], "coarse2fine-g12-s4")])
def test_serving_cli_hierarchical(argv, mode):
    ops.reset_dispatch()
    rep = tserve.main(["--smoke", "--device", "cpu", "--requests", "6",
                       "--max-size", "5", "--target", "hierarchical", *argv])
    assert rep["backend"] == "hierarchical" and rep["mode"] == mode
    assert rep["topk"] == (4 if "--topk" in argv else 0)
    tiers = rep["metrics"]["dispatch_tiers"]
    assert set(tiers["am_shortlist"]) == set(tiers["am_search_sparse"]) == {
        "torch-ref"}


@pytest.mark.parametrize("argv", [["--topk", "2"], ["--groups", "4"],
                                  ["--target", "packed", "--shortlist", "2"]])
def test_serving_cli_refuses_hierarchical_flags_elsewhere(argv):
    with pytest.raises(SystemExit):
        tserve.main(["--smoke", "--device", "cpu", *argv])
