"""Multi-device MEMHD on the CPU: ``deploy.ShardedArtifact``,
``qail.qail_batch_delta``, ``core.distributed`` and
``MemhdModel.fit_sharded`` against the reference's single-device paths.

The port's mesh is a tuple of devices; on the CPU ``("cpu",) * k`` runs k
shards in one process, the counterpart of the reference's
``--xla_force_host_platform_device_count``. The reference's own sharded
serving fails on this tree (``deploy/sharded.py`` passes ``check_rep`` to
jax 0.9's ``shard_map``), so every sharded result is held against the
reference's single-device one, from converted weights.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EncoderConfig as JEncoderConfig  # noqa: E402
from repro.core import MemhdConfig as JMemhdConfig  # noqa: E402
from repro.core import MemhdModel as JModel  # noqa: E402
from repro.core import am as jam  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core import qail as jqail  # noqa: E402
from repro.data import load_dataset as jax_load_dataset  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distributed, qail, types  # noqa: E402
from repro_torch.deploy import ShardedArtifact, serving_mesh  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

F = 64
TARGETS = {"packed": {}, "unpacked": {}, "multibit": {"cell_bits": 4},
           "imc": {}, "hierarchical": {}}
# Ragged request sizes: none a multiple of 8 (or of 3).
ROWS = (1, 5, 13, 22, 37)


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _dyadic(x):
    return (np.round(np.asarray(x)[:, :F] * 256) / 256).astype(np.float32)


def cpu_mesh(k):
    return ("cpu",) * k


@pytest.fixture(scope="module")
def pair():
    """A JAX model initialized by clustering and its port (dyadic
    features and initial AM, as in tests/test_torch_pipeline.py)."""
    ds = jax_load_dataset("mnist", train_per_class=30, test_per_class=10)
    tr_x, te_x = _dyadic(ds.train_x), _dyadic(ds.test_x)
    tr_y, te_y = np.asarray(ds.train_y), np.asarray(ds.test_y)
    enc = JEncoderConfig(kind="projection", features=F, dim=128)
    amc = JMemhdConfig(dim=128, columns=128, classes=10, epochs=2,
                       lr=0.0625, normalize="none", kmeans_iters=5,
                       batch_size=64)
    jm = JModel.create(jax.random.key(0), enc, amc)
    jm, _ = jm.initialize_am(jax.random.key(1), tr_x, tr_y)
    fp0 = np.round(np.asarray(jm.am_state["fp"]) * 256) / 256
    jm = dataclasses.replace(jm, am_state=jam.make_am_state(
        jnp.asarray(fp0, jnp.float32), jm.am_state["centroid_class"],
        amc.threshold))
    tm = convert.model_from_numpy(
        {"projection": np.asarray(jm.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jm.am_state.items()},
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    return dict(jm=jm, tm=tm, tr_x=tr_x, tr_y=tr_y, te_x=te_x, te_y=te_y)


@pytest.fixture(scope="module")
def artifacts(pair):
    return {t: (pair["tm"].deploy(target=t, **kw),
                pair["jm"].deploy(target=t, **kw))
            for t, kw in TARGETS.items()}


# -- the mesh and the wrapper ---------------------------------------------------

def test_serving_mesh():
    assert serving_mesh(["cpu", "cpu"]) == (torch.device("cpu"),) * 2
    assert serving_mesh(["cpu"] * 3, n=2) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="requested 4 devices, have 3"):
        serving_mesh(["cpu"] * 3, n=4)
    with pytest.raises(ValueError, match="requested 0"):
        serving_mesh(["cpu"], n=0)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no devices"):
            serving_mesh()


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("k", [1, 3, 8])
def test_sharded_equals_single_device_and_reference(artifacts, pair, target,
                                                    k):
    tdep, jdep = artifacts[target]
    sh = ShardedArtifact(tdep, mesh=cpu_mesh(k))
    assert (sh.n_devices, sh.row_multiple) == (k, k)
    assert sh.backend == tdep.backend and sh.device == torch.device("cpu")
    ofs = 0
    for rows in ROWS:
        x = pair["te_x"][ofs:ofs + rows]
        ofs += rows
        want = np.asarray(jdep.predict(x))
        got = sh.predict(x)
        assert got.shape == (rows,)
        np.testing.assert_array_equal(n(got), want)
        np.testing.assert_array_equal(n(tdep.predict(x)), want)
        np.testing.assert_array_equal(n(sh.predict_features(x)), want)
        q = pair["tm"].encode_query(x)
        np.testing.assert_array_equal(n(sh.predict_query(q)),
                                      n(tdep.predict_query(q)))
        # A tensor batch shards like a numpy one.
        np.testing.assert_array_equal(n(sh.predict(torch.as_tensor(x))),
                                      want)
    x, y = pair["te_x"], pair["te_y"]
    assert sh.score(x, y, batch=32) == tdep.score(x, y, batch=32) \
        == jdep.score(x, y, batch=32)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_sharded_topk_equals_single_device_and_reference(artifacts, pair,
                                                         k):
    tdep, jdep = artifacts["hierarchical"]
    sh = ShardedArtifact(tdep, mesh=cpu_mesh(k))
    for rows in ROWS:
        x = pair["te_x"][:rows]
        got = sh.predict_topk(x, 5)
        single = tdep.predict_topk(x, 5)
        want = jdep.predict_topk(x, 5)
        for g, s, w in zip(got, single, want):
            assert g.shape == (rows, 5)
            assert torch.equal(g, s)
            np.testing.assert_array_equal(n(g), np.asarray(w))
    flat = ShardedArtifact(artifacts["packed"][0], mesh=cpu_mesh(k))
    with pytest.raises(AttributeError, match="predict_topk"):
        flat.predict_topk(pair["te_x"][:3], 2)


def test_with_artifact_and_refresh_share_the_replica_cache(pair, artifacts):
    tdep = artifacts["packed"][0]
    sh = ShardedArtifact(tdep, mesh=cpu_mesh(2))
    same = sh.with_artifact(tdep)
    assert same._replicas is sh._replicas and same.mesh == sh.mesh
    assert len(sh._replicas) == 1  # one artifact: its copies made once
    tm2, _ = pair["tm"].fit(2, pair["tr_x"], pair["tr_y"],
                            init_method="keep", epochs=1)
    new = sh.refresh(tm2)
    assert isinstance(new, ShardedArtifact)
    assert new._replicas is sh._replicas and new.mesh == sh.mesh
    assert len(sh._replicas) == 2
    x = pair["te_x"][:21]
    np.testing.assert_array_equal(n(new.predict(x)),
                                  n(tm2.deploy(target="packed").predict(x)))
    # The old wrapper still serves its own generation.
    np.testing.assert_array_equal(n(sh.predict(x)), n(tdep.predict(x)))


def test_swap_signature_is_stable_across_a_same_c_fold(pair, artifacts):
    for target in ("packed", "hierarchical"):
        tdep = artifacts[target][0]
        sh = ShardedArtifact(tdep, mesh=cpu_mesh(3))
        assert sh.swap_signature[:-1] == tdep.swap_signature
        assert sh.swap_signature[-1] == ("mesh", ("cpu",) * 3)
        tm2, _ = pair["tm"].fit(4, pair["tr_x"], pair["tr_y"],
                                init_method="keep", epochs=1)
        assert sh.refresh(tm2).swap_signature == sh.swap_signature
        other = ShardedArtifact(tdep, mesh=cpu_mesh(2))
        assert other.swap_signature != sh.swap_signature


def test_double_wrapping_raises(artifacts):
    sh = ShardedArtifact(artifacts["packed"][0], mesh=cpu_mesh(2))
    with pytest.raises(TypeError, match="already sharded"):
        ShardedArtifact(sh, mesh=cpu_mesh(2))
    with pytest.raises(TypeError, match="already sharded"):
        sh.with_artifact(sh)
    with pytest.raises(ValueError, match="requested 9 devices"):
        serving_mesh(cpu_mesh(8), n=9)


def test_empty_batch(artifacts, pair):
    sh = ShardedArtifact(artifacts["packed"][0], mesh=cpu_mesh(3))
    assert sh.predict(pair["te_x"][:0]).shape == (0,)


# -- qail_batch_delta ---------------------------------------------------------

def _delta_operands(seed, b, d, c, classes, dyadic_h):
    rng = np.random.default_rng(seed)
    fp = rng.normal(size=(c, d)).astype(np.float32)
    binary = np.where(fp >= 0, 1.0, -1.0).astype(np.float32)
    owners = rng.integers(0, classes, size=c).astype(np.int32)
    h = rng.normal(size=(b, d)).astype(np.float32)
    if dyadic_h:
        h = np.round(h * 16) / 16
    q = np.where(h >= 0, 1.0, -1.0).astype(np.float32)
    labels = rng.integers(0, classes, size=b).astype(np.int32)
    mask = (rng.random(b) < 0.8).astype(np.float32)
    return {"fp": fp, "binary": binary, "centroid_class": owners}, h, q, \
        labels, mask


def _both_deltas(state, cfg_kw, h, q, labels, mask):
    jcfg = JMemhdConfig(**cfg_kw)
    tcfg = types.MemhdConfig(**cfg_kw)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    jd, jm = jqail.qail_batch_delta(jstate, jcfg, jnp.asarray(h),
                                    jnp.asarray(q), jnp.asarray(labels),
                                    mask=None if mask is None
                                    else jnp.asarray(mask))
    td, tm = qail.qail_batch_delta(tstate, tcfg, torch.as_tensor(h),
                                   torch.as_tensor(q),
                                   torch.as_tensor(labels),
                                   mask=None if mask is None
                                   else torch.as_tensor(mask))
    return (td, tm), (jd, jm), tstate, tcfg


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("b,d,c,classes", [(256, 128, 64, 10),
                                           (200, 96, 8, 2),
                                           (37, 130, 300, 30)])
def test_qail_batch_delta_bit_exact_where_every_sum_is(masked, b, d, c,
                                                       classes):
    """±1 payload (update_with="binary"), lr = 2^-4, at most 256 terms a
    cell: every partial sum is a multiple of 2^-4 below 2^4, exact in
    bfloat16, so the port equals the reference bit for bit."""
    state, h, q, labels, mask = _delta_operands([b, d, c], b, d, c, classes,
                                                dyadic_h=False)
    (td, tm), (jd, jm), _, _ = _both_deltas(
        state, dict(dim=d, columns=c, classes=classes, lr=0.0625,
                    update_with="binary"), h, q, labels,
        mask if masked else None)
    assert td.dtype == torch.bfloat16 and td.shape == (c, d)
    np.testing.assert_array_equal(td.float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    assert float(tm) == float(jm)
    assert float(tm) > 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("wire", ["bfloat16", "float32"])
def test_qail_batch_delta_within_wire_rounding_elsewhere(masked, wire):
    """The encoded float payload at lr = 0.02: the port and the reference
    each round every term and every partial sum to the wire dtype; they
    differ by at most (m + 1) ulps of it times the sum of |terms| (m terms
    a cell)."""
    b, d, c, classes = 256, 64, 16, 4
    state, h, q, labels, mask = _delta_operands(7, b, d, c, classes,
                                                dyadic_h=False)
    cfg_kw = dict(dim=d, columns=c, classes=classes, lr=0.02)
    mask = mask if masked else None
    jcfg, tcfg = JMemhdConfig(**cfg_kw), types.MemhdConfig(**cfg_kw)
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    jd, jm = jqail.qail_batch_delta(
        jstate, jcfg, jnp.asarray(h), jnp.asarray(q), jnp.asarray(labels),
        wire_dtype=getattr(jnp, wire),
        mask=None if mask is None else jnp.asarray(mask))
    td, tm = qail.qail_batch_delta(
        tstate, tcfg, torch.as_tensor(h), torch.as_tensor(q),
        torch.as_tensor(labels), wire_dtype=getattr(torch, wire),
        mask=None if mask is None else torch.as_tensor(mask))
    assert td.dtype == getattr(torch, wire)
    # Terms per cell: |lr * mis * h| of each row whose target is the cell.
    pred_t, true_t, mis = ref.qail_targets(
        torch.as_tensor(q), tstate["binary"].T, tstate["centroid_class"],
        torch.as_tensor(labels),
        torch.ones(b) if mask is None else torch.as_tensor(mask))
    w = torch.nn.functional.one_hot(true_t, c).float() + \
        torch.nn.functional.one_hot(pred_t, c).float()
    w = w * mis[:, None]
    terms = (w.T @ (0.02 * torch.as_tensor(h).abs())).numpy()
    m = w.sum(dim=0).numpy()[:, None]
    ulp = 2.0 ** -8 if wire == "bfloat16" else 2.0 ** -24
    diff = np.abs(td.float().numpy() - np.asarray(jd.astype(jnp.float32)))
    assert (diff <= (m + 1) * ulp * terms).all()
    assert float(tm) == float(jm)


def test_qail_batch_delta_kernel_route_on_the_cpu_is_the_plain_delta():
    """use_kernel=True on CPU tensors dispatches ops.qail_update's plain
    tier (a float32 delta, rounded once to the wire dtype): under exact
    conditions it equals the row-order bfloat16 plain version."""
    state, h, q, labels, mask = _delta_operands(11, 128, 64, 32, 4,
                                                dyadic_h=False)
    tcfg = types.MemhdConfig(dim=64, columns=32, classes=4, lr=0.0625,
                             update_with="binary")
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    args = (tstate, tcfg, torch.as_tensor(h), torch.as_tensor(q),
            torch.as_tensor(labels))
    ops.reset_dispatch()
    kd, km = qail.qail_batch_delta(*args, mask=torch.as_tensor(mask),
                                   use_kernel=True)
    assert ops.dispatch_breakdown()["qail_update"] == {"torch-ref": 1}
    pd, pm = qail.qail_batch_delta(*args, mask=torch.as_tensor(mask))
    assert torch.equal(kd, pd) and torch.equal(km, pm)


# -- the data-parallel fit ----------------------------------------------------

@pytest.fixture(scope="module")
def hdc():
    from repro_torch.data import load_dataset
    return load_dataset("mnist", train_per_class=40, test_per_class=10,
                        device="cpu")


def _exact_model(hdc, dim=128, columns=32):
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    enc = EncoderConfig(kind="projection", features=hdc.features, dim=dim)
    amc = MemhdConfig(dim=dim, columns=columns, classes=hdc.classes,
                      epochs=3, kmeans_iters=5, batch_size=128, lr=0.0625,
                      update_with="binary")
    return MemhdModel.create(0, enc, amc, device="cpu")


def test_fit_sharded_one_and_four_shards_bit_equal(hdc):
    """Dyadic features, lr = 2^-4, the ±1 payload: every shard delta and
    their bfloat16 sum are exact, so the shard count changes no bit."""
    x = torch.round(hdc.train_x * 16) / 16
    m = _exact_model(hdc)
    fits = {k: m.fit_sharded(1, x, hdc.train_y, mesh=cpu_mesh(k))
            for k in (1, 4)}
    (m1, h1), (m4, h4) = fits[1], fits[4]
    for key in ("fp", "binary", "centroid_class"):
        assert torch.equal(m1.am_state[key], m4.am_state[key]), key
    assert h1["curve"] == h4["curve"] and len(h1["curve"]) == 3
    assert h1["init"] == h4["init"]
    assert h1["curve"][0]["train_miss"] > 0.1
    # ... and equal to the single-device fit, which sums in float32.
    mf, hf = m.fit(1, x, hdc.train_y)
    assert torch.equal(mf.am_state["fp"], m1.am_state["fp"])
    assert [r["train_miss"] for r in hf["curve"]] == \
        [r["train_miss"] for r in h1["curve"]]


def test_fit_sharded_matches_the_reference_fit(monkeypatch):
    """The reference's own contract (tests/test_qail_engine.py::
    TestFitSharded): from the same initial AM (the reference's clustering
    init, crossed in place of the port's own draws), the port's
    fit_sharded over two CPU shards, syncing bfloat16 deltas, agrees with
    the reference's single-device fit on > 95 % of binary cells and within
    0.05 in accuracy, with 3 curve entries."""
    ds = jax_load_dataset("mnist", train_per_class=150, test_per_class=40)
    enc = JEncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = JMemhdConfig(dim=128, columns=32, classes=ds.classes, epochs=3,
                       kmeans_iters=5, batch_size=128)
    jm = JModel.create(jax.random.key(0), enc, amc)
    jm0, _ = jm.initialize_am(jax.random.key(1), ds.train_x, ds.train_y)
    jfit, _ = jm0.fit(jax.random.key(1), ds.train_x, ds.train_y,
                      init_method="keep")
    tm0 = convert.model_from_numpy(
        {"projection": np.asarray(jm0.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jm0.am_state.items()},
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    from repro_torch.core import MemhdModel
    monkeypatch.setattr(MemhdModel, "initialize_am",
                        lambda self, *a, **kw: (tm0, []))
    tsh, hist = tm0.fit_sharded(1, np.asarray(ds.train_x),
                                np.asarray(ds.train_y), mesh=cpu_mesh(2))
    agree = (tsh.am_state["binary"].numpy()
             == np.asarray(jfit.am_state["binary"])).mean()
    assert agree > 0.95, agree
    acc_j = jfit.score(ds.test_x, ds.test_y)
    acc_t = tsh.score(np.asarray(ds.test_x), np.asarray(ds.test_y))
    assert abs(acc_j - acc_t) < 0.05, (acc_j, acc_t)
    assert len(hist["curve"]) == 3


def test_fit_sharded_batch_rounds_to_the_shard_count(hdc, monkeypatch):
    seen = {}
    real = distributed.fit_sharded_epochs

    def spy(mesh, am_state, cfg, hb, *args, **kw):
        seen["bs"] = hb.shape[1]
        return real(mesh, am_state, cfg, hb, *args, **kw)

    monkeypatch.setattr(distributed, "fit_sharded_epochs", spy)
    _exact_model(hdc).fit_sharded(1, hdc.train_x, hdc.train_y,
                                  mesh=cpu_mesh(3), epochs=1)
    assert seen["bs"] == 129  # ceil(128 / 3) * 3
    with pytest.raises(ValueError, match="equal shards"):
        distributed.shard_prebatched(cpu_mesh(3), *qail.prebatch(
            hdc.train_x[:10, :4], hdc.train_x[:10, :4], hdc.train_y[:10],
            4))


def test_make_epoch_fn_single_device_matches_the_reference(pair):
    """One whole epoch (encode, one snapshot's delta, step 4) of the
    port's make_epoch_fn(mesh=None) against the reference's: dyadic
    features make the encode exact; the bfloat16 delta is summed in the
    same order; the l2 normalization's reductions may differ in the last
    ulp (|d fp| <= 1e-6 * max|fp|, >= 99.9 % equal binary cells)."""
    jm, tm = pair["jm"], pair["tm"]
    amc = dataclasses.replace(jm.am_cfg, normalize="l2", lr=0.02)
    tamc = types.MemhdConfig(**dataclasses.asdict(amc))
    x, y = pair["tr_x"], pair["tr_y"]
    jst, jmiss = jdist.make_epoch_fn(jm.enc_cfg, amc, None)(
        jm.enc_params, jm.am_state, jnp.asarray(x), jnp.asarray(y))
    tst, tmiss = distributed.make_epoch_fn(tm.enc_cfg, tamc, None)(
        tm.enc_params, tm.am_state, torch.tensor(x), torch.tensor(y))
    assert float(tmiss) == float(jmiss) > 0
    jfp = np.asarray(jst["fp"])
    assert np.abs(tst["fp"].numpy() - jfp).max() <= 1e-6 * np.abs(jfp).max()
    agree = (tst["binary"].numpy() == np.asarray(jst["binary"])).mean()
    assert agree >= 0.999, agree


def test_fit_distributed_over_two_cpu_shards(pair):
    """fit_distributed over ("cpu", "cpu") under exact conditions (dyadic
    features exact in bfloat16, the ±1 payload at lr = 2^-4): equal to
    the single-device whole-epoch fit bit for bit."""
    tm = pair["tm"]
    tm = dataclasses.replace(tm, am_cfg=dataclasses.replace(
        tm.am_cfg, update_with="binary"))
    x, y = torch.tensor(pair["tr_x"]), torch.tensor(pair["tr_y"])
    two = distributed.fit_distributed(cpu_mesh(2), tm, x, y, epochs=2)
    one = distributed.fit_distributed(cpu_mesh(1), tm, x, y, epochs=2)
    epoch = distributed.make_epoch_fn(tm.enc_cfg, tm.am_cfg, None)
    state = tm.am_state
    for _ in range(2):
        state, _ = epoch(tm.enc_params, state, x, y)
    for key in ("fp", "binary"):
        assert torch.equal(two.am_state[key], one.am_state[key])
        assert torch.equal(two.am_state[key], state[key])
    assert not torch.equal(two.am_state["fp"], tm.am_state["fp"])


def test_make_inference_fn_matches_the_reference(pair):
    jm, tm = pair["jm"], pair["tm"]
    x = pair["te_x"]
    want = jdist.make_inference_fn(jm.enc_cfg, jm.am_cfg)(
        jm.enc_params, jm.am_state["binary"], jm.am_state["centroid_class"],
        jnp.asarray(x))
    got = distributed.make_inference_fn(tm.enc_cfg, tm.am_cfg)(
        tm.enc_params, tm.am_state["binary"], tm.am_state["centroid_class"],
        torch.as_tensor(x))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(got), n(tm.predict(x)))
    # The dry runs no longer raise: on an abstract (2, 4) mesh they count
    # one member's run on meta tensors (tests/test_torch_dryrun.py holds
    # them against the reference).
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh(None, ("data", "model"), (2, 4))
    for fn in (distributed.dryrun_inference, distributed.dryrun_epoch):
        rep = fn(mesh, features=F, dim=64, columns=32, **{
            "n_queries" if fn is distributed.dryrun_inference
            else "n_samples": 512})
        assert rep["roofline"]["flops_per_dev"] > 0
        assert rep["roofline"]["chips"] == 8


# -- the launchers ------------------------------------------------------------

def test_serve_memhd_devices_on_cpu_shards():
    from repro_torch.launch import serve_memhd as tserve
    rep = tserve.main(["--smoke", "--device", "cpu", "--devices", "2",
                       "--requests", "16", "--max-size", "7"])
    assert rep["devices"] == 2
    assert rep["rows_per_s_per_device"] == pytest.approx(
        rep["rows_per_s"] / 2, abs=0.1)
    assert rep["metrics"]["recompiles_steady_state"] == 0
    one = tserve.main(["--smoke", "--device", "cpu", "--requests", "16",
                       "--max-size", "7"])
    assert one["devices"] == 1 and one["rows"] == rep["rows"]
    with pytest.raises(ValueError, match="requested 0"):
        tserve.main(["--smoke", "--device", "cpu", "--devices", "0"])


def test_serve_batches_rounds_the_tile_to_the_shard_count(artifacts, pair):
    from repro_torch.launch import serve_memhd as tserve
    tdep = artifacts["packed"][0]
    sh = ShardedArtifact(tdep, mesh=cpu_mesh(3))
    reqs = tserve.synthetic_requests(pair["te_x"], 11, 7, seed=2)
    got, stats = tserve.serve_batches(sh, reqs, max_batch=20)
    want, _ = tserve.serve_batches(tdep, reqs, max_batch=20)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    # Every padded batch a multiple of lcm(8, 3) = 24.
    assert stats["rows_padded"] % 24 == 0


def test_serve_online_devices_on_cpu_shards():
    from repro_torch.launch import serve_online
    rep = serve_online.main(["--smoke", "--append-class", "--device", "cpu",
                             "--devices", "2", "--requests", "16"])
    assert rep["devices"] == 2
    assert rep["model_generation"] == 2
    assert rep["recompiles_steady_state"] == 0
    assert [g["shape_stable"] for g in rep["generations"]] == [True, False]
    one = serve_online.main(["--smoke", "--append-class", "--device", "cpu",
                             "--requests", "16"])
    assert one["devices"] == 1
    for p in ("A", "B", "C"):
        assert rep["phases"][p]["accuracy"] == one["phases"][p]["accuracy"]


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_a_second_device_gets_one_replica(artifacts, pair, target):
    """A mesh that names a device other than the artifact's: ``cpu:0`` is
    a torch device distinct from the artifact's ``cpu``. The wrapper makes
    one replica (every tensor field and dict field rebuilt through
    ``_replica``), repeated entries share it, the artifact's own device
    serves it as it is, and the gathered outputs equal the unwrapped
    artifact's. The card tests repeat this across the card and the CPU."""
    tdep = artifacts[target][0]
    other = torch.device("cpu", 0)
    sh = ShardedArtifact(tdep, mesh=("cpu", other, other))
    reps = sh._replicas.of(tdep, set(sh.mesh))
    assert list(reps) == [other] and len(sh._replicas) == 1
    rep = reps[other]
    assert rep is not tdep and type(rep) is type(tdep)
    for f in dataclasses.fields(tdep):
        v = getattr(tdep, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(rep, f.name), v), f.name
        elif isinstance(v, dict):
            assert set(getattr(rep, f.name)) == set(v), f.name
    assert sh.device == torch.device("cpu")
    for rows in ROWS:
        x = pair["te_x"][:rows]
        np.testing.assert_array_equal(n(sh.predict(x)), n(tdep.predict(x)))
    new = sh.with_artifact(tdep)
    assert new._replicas.of(tdep, set(new.mesh)) is reps
