"""The port's core modules against the JAX package's, on the CPU.

Configs, datasets, encoding, AM quantization and packing, k-means,
cluster allocation and the QAIL epoch, each fed the same numpy inputs on
both sides. Exact where the arithmetic is exact (integer similarities,
dyadic features and learning rate, power-of-two D*C); the tolerance is
stated where float rounding enters.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import am as jam  # noqa: E402
from repro.core import encoding as jenc  # noqa: E402
from repro.core import init as jinit  # noqa: E402
from repro.core import kmeans as jkm  # noqa: E402
from repro.core import qail as jqail  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.data import hdc as jhdc  # noqa: E402
from repro_torch.core import am, encoding, evaluate, init, kmeans, qail  # noqa: E402
from repro_torch.core import types  # noqa: E402
from repro_torch.data import hdc  # noqa: E402

CONFIG_CLASSES = ["EncoderConfig", "MemhdConfig", "ImcArrayConfig",
                  "ImcSimConfig", "BaselineConfig", "DatasetSpec"]


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def dyadic(rng, shape, scale=1.0):
    return (np.round(rng.random(shape) * scale * 256) / 256).astype(
        np.float32)


def bipolar(rng, shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


# -- configs and data -----------------------------------------------------------

@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_copies_match_field_by_field(name):
    ref_cls, port_cls = getattr(jtypes, name), getattr(types, name)

    def fields(cls):
        return [(f.name, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    assert fields(port_cls) == fields(ref_cls)


def test_config_values_and_validation_match():
    enc = jtypes.EncoderConfig(features=64, dim=256, binarize_query=False)
    amc = jtypes.MemhdConfig(dim=256, columns=64, classes=5, lr=0.05,
                             normalize="none", epochs=3)
    p_enc = types.EncoderConfig(**dataclasses.asdict(enc))
    p_amc = types.MemhdConfig(**dataclasses.asdict(amc))
    assert dataclasses.asdict(p_enc) == dataclasses.asdict(enc)
    assert p_enc.memory_bits == enc.memory_bits
    assert p_amc.initial_clusters_per_class == amc.initial_clusters_per_class
    assert p_amc.am_memory_bits_at(4) == amc.am_memory_bits_at(4)
    assert ({k: dataclasses.asdict(v) for k, v in types.DATASETS.items()}
            == {k: dataclasses.asdict(v) for k, v in jtypes.DATASETS.items()})
    for bad in ({"columns": 3, "classes": 5}, {"init_ratio": 0.0},
                {"normalize": "l1"}):
        with pytest.raises(ValueError):
            jtypes.MemhdConfig(**bad)
        with pytest.raises(ValueError):
            types.MemhdConfig(**bad)


@pytest.mark.parametrize("name,seed", [("mnist", 0), ("isolet", 3)])
def test_synthesize_is_bit_identical(name, seed):
    ref = jhdc.synthesize(name, jtypes.dataset_spec(name), seed, 12, 5)
    got = hdc.synthesize(name, types.dataset_spec(name), seed, 12, 5,
                         device="cpu")
    for field in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(n(getattr(got, field)),
                                      np.asarray(getattr(ref, field)))
    assert got.train_y.dtype == torch.int32
    assert got.source == ref.source == "synthetic"


def test_real_loader_and_subsample(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    z = dict(train_x=rng.random((40, 784), dtype=np.float32),
             train_y=np.repeat(np.arange(10), 4).astype(np.int32),
             test_x=rng.random((20, 784), dtype=np.float32),
             test_y=np.repeat(np.arange(10), 2).astype(np.int32))
    np.savez(tmp_path / "mnist.npz", **z)
    monkeypatch.setenv("MEMHD_DATA_DIR", str(tmp_path))
    ref = jhdc.load_dataset("mnist", train_per_class=3, test_per_class=1)
    got = hdc.load_dataset("mnist", train_per_class=3, test_per_class=1,
                           device="cpu")
    assert got.source == ref.source == "real"
    for field in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(n(getattr(got, field)),
                                      np.asarray(getattr(ref, field)))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_padding_helpers_match(as_tensor):
    from repro.deploy import padding as jpad
    from repro_torch.deploy import padding
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    arg = torch.from_numpy(x) if as_tensor else x
    kind = torch.Tensor if as_tensor else np.ndarray
    for fill in ("zero", "edge"):
        got = padding.pad_rows(arg, 8, fill=fill)
        assert isinstance(got, kind)
        np.testing.assert_array_equal(n(got), jpad.pad_rows(x, 8, fill=fill))
    got, n_valid = padding.pad_to_multiple(arg, 4)
    want, w_valid = jpad.pad_to_multiple(x, 4)
    assert isinstance(got, kind) and n_valid == w_valid
    np.testing.assert_array_equal(n(got), want)
    got = padding.pad_tiles(arg, 4, 8, value=-1.0)
    assert isinstance(got, kind)
    np.testing.assert_array_equal(
        n(got), np.asarray(jpad.pad_tiles(jnp.asarray(x), 4, 8, value=-1.0)))
    v = arg[:, 0]
    np.testing.assert_array_equal(
        n(padding.pad_vec(v, 7, value=-1)),
        np.asarray(jpad.pad_vec(jnp.asarray(x[:, 0]), 7, value=-1)))
    assert padding.round_up(13, 8) == jpad.round_up(13, 8) == 16
    with pytest.raises(ValueError):
        padding.pad_rows(arg, 2)


# -- encoding -----------------------------------------------------------------

def test_encode_projection_and_binarize_query():
    rng = np.random.default_rng(1)
    x, m = dyadic(rng, (6, 40)), bipolar(rng, (40, 72))
    got = encoding.encode_projection({"projection": torch.from_numpy(m)},
                                     torch.from_numpy(x))
    want = jenc.encode_projection({"projection": jnp.asarray(m)},
                                  jnp.asarray(x))
    np.testing.assert_array_equal(n(got), np.asarray(want))  # dyadic: exact
    h = np.array([[-1.5, -0.0, 0.0, 2.0, -1e-30]], np.float32)
    np.testing.assert_array_equal(
        n(encoding.binarize_query(torch.from_numpy(h))),
        np.asarray(jenc.binarize_query(jnp.asarray(h))))
    np.testing.assert_array_equal(
        n(encoding.binarize_query(torch.from_numpy(h))),
        [[-1.0, 1.0, 1.0, 1.0, -1.0]])  # sign(0) -> +1


def test_init_projection_is_seeded_rademacher():
    cfg = types.EncoderConfig(features=30, dim=50)
    a = encoding.init_projection(torch.Generator().manual_seed(5), cfg)
    b = encoding.init_projection(torch.Generator().manual_seed(5), cfg)
    p = a["projection"]
    assert p.shape == (30, 50) and p.dtype == torch.float32
    assert set(np.unique(n(p))) == {-1.0, 1.0}
    assert torch.equal(p, b["projection"])


# -- associative memory -------------------------------------------------------

def test_binarize_am_ties_at_the_mean_go_to_minus_one():
    fp = np.array([[0.5, 0.25, 0.0, 0.25], [0.25, 0.5, 0.0, 0.25]],
                  np.float32)
    assert fp.mean() == 0.25
    got = n(am.binarize_am(torch.from_numpy(fp)))
    np.testing.assert_array_equal(got, np.asarray(jam.binarize_am(
        jnp.asarray(fp))))
    assert (got[fp == 0.25] == -1.0).all()  # strict '>' against the mean
    rng = np.random.default_rng(2)
    fp = dyadic(rng, (16, 24), scale=4.0) - 2.0
    for thr in ("mean", "per_centroid"):
        np.testing.assert_array_equal(
            n(am.binarize_am(torch.from_numpy(fp), thr)),
            np.asarray(jam.binarize_am(jnp.asarray(fp), thr)))


@pytest.mark.parametrize("c,d", [(10, 128), (26, 130), (3, 9)])
def test_pack_am_and_searches_match(c, d):
    rng = np.random.default_rng([3, c, d])
    binary = bipolar(rng, (c, d))
    owners = rng.integers(0, 4, size=c).astype(np.int32)
    queries = bipolar(rng, (7, d))
    packed = am.pack_am(torch.from_numpy(binary))
    np.testing.assert_array_equal(n(packed),
                                  np.asarray(jam.pack_am(jnp.asarray(binary))))
    assert packed.is_contiguous()
    assert am.packed_am_bytes(d, c) == jam.packed_am_bytes(d, c)
    sims = am.similarities(torch.from_numpy(binary), torch.from_numpy(queries))
    np.testing.assert_array_equal(n(sims), np.asarray(jam.similarities(
        jnp.asarray(binary), jnp.asarray(queries))))
    np.testing.assert_array_equal(
        n(am.class_max_sims(sims, torch.from_numpy(owners), 5)),
        np.asarray(jam.class_max_sims(jnp.asarray(n(sims)),
                                      jnp.asarray(owners), 5)))
    pred = am.predict(torch.from_numpy(binary), torch.from_numpy(owners),
                      torch.from_numpy(queries))
    np.testing.assert_array_equal(n(pred), np.asarray(jam.predict(
        jnp.asarray(binary), jnp.asarray(owners), jnp.asarray(queries))))
    np.testing.assert_array_equal(
        n(am.packed_predict(packed, torch.from_numpy(owners),
                            torch.from_numpy(queries), d)), n(pred))
    np.testing.assert_array_equal(
        n(am.to_unipolar(torch.from_numpy(binary))),
        np.asarray(jam.to_unipolar(jnp.asarray(binary))))
    np.testing.assert_array_equal(
        n(am.from_unipolar(am.to_unipolar(torch.from_numpy(binary)))),
        binary)


# -- clustering init ----------------------------------------------------------

def test_kmeans_dot_with_same_init():
    rng = np.random.default_rng(4)
    centers = rng.normal(0, 3, (5, 32)).astype(np.float32)
    h = (centers[rng.integers(0, 5, 200)]
         + rng.normal(0, 0.5, (200, 32))).astype(np.float32)
    init_c = h[rng.choice(200, 6, replace=False)]
    want_c, want_a = jkm.kmeans_dot(jax.random.key(0), jnp.asarray(h), 6,
                                    10, init=jnp.asarray(init_c))
    got_c, got_a = kmeans.kmeans_dot(None, torch.from_numpy(h), 6, 10,
                                     init=torch.from_numpy(init_c))
    np.testing.assert_array_equal(n(got_a), np.asarray(want_a))
    np.testing.assert_allclose(n(got_c), np.asarray(want_c), rtol=1e-5,
                               atol=1e-6)


def test_kmeans_dot_random_init_and_classwise():
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.normal(size=(60, 16)).astype(np.float32))
    labels = torch.from_numpy(np.repeat(np.arange(3), 20).astype(np.int32))
    g = torch.Generator().manual_seed(0)
    c, a = kmeans.kmeans_dot(g, h, 4, 5)
    assert c.shape == (4, 16) and a.shape == (60,) and a.dtype == torch.int32
    cents, owners = kmeans.classwise_kmeans(g, h, labels, 3, [2, 1, 25], 3)
    assert cents.shape == (28, 16)
    np.testing.assert_array_equal(n(owners), [0, 0, 1] + [2] * 25)


def test_confusion_and_mispredictions_match():
    rng = np.random.default_rng(6)
    pred = rng.integers(0, 4, 50).astype(np.int32)
    true = rng.integers(0, 4, 50).astype(np.int32)
    conf = init.confusion_matrix(torch.from_numpy(pred),
                                 torch.from_numpy(true), 4)
    jconf = jinit.confusion_matrix(jnp.asarray(pred), jnp.asarray(true), 4)
    np.testing.assert_array_equal(n(conf), np.asarray(jconf))
    np.testing.assert_array_equal(n(init.misprediction_counts(conf)),
                                  np.asarray(jinit.misprediction_counts(jconf)))


def test_allocate_round_matches_on_random_integers():
    rng = np.random.default_rng(7)
    for _ in range(300):
        k = int(rng.integers(1, 12))
        mispred = rng.integers(0, 40, k) * (rng.random(k) < 0.7)
        budgets = rng.integers(1, 10, k).astype(np.int64)
        max_pc = budgets + rng.integers(0, 8, k)
        spare = int(rng.integers(0, 30))
        got = init._allocate_round(mispred.copy(), budgets.copy(), spare,
                                   max_pc.copy())
        want = jinit._allocate_round(mispred.copy(), budgets.copy(), spare,
                                     max_pc.copy())
        np.testing.assert_array_equal(got, want)


def test_clustering_init_fills_every_column():
    rng = np.random.default_rng(8)
    h = torch.from_numpy(rng.normal(size=(120, 32)).astype(np.float32))
    labels = torch.from_numpy(np.repeat(np.arange(4), 30).astype(np.int32))
    cfg = types.MemhdConfig(dim=32, columns=24, classes=4, kmeans_iters=4)
    fp, owners, hist = init.clustering_init(torch.Generator().manual_seed(1),
                                            cfg, h, labels)
    assert fp.shape == (24, 32) and owners.shape == (24,)
    assert set(n(owners).tolist()) == {0, 1, 2, 3}
    assert hist and hist[-1]["spare"] == 0


# -- QAIL ---------------------------------------------------------------------

def _qail_inputs(seed, n_rows, d, c, k, lr_feats):
    rng = np.random.default_rng(seed)
    h = dyadic(rng, (n_rows, d), scale=8.0) - 4.0 if lr_feats else \
        rng.normal(0, 3, (n_rows, d)).astype(np.float32)
    q = np.where(h >= 0, 1.0, -1.0).astype(np.float32)
    y = rng.integers(0, k, n_rows).astype(np.int32)
    fp = (dyadic(rng, (c, d), scale=8.0) - 4.0 if lr_feats
          else rng.normal(0, 3, (c, d)).astype(np.float32))
    owners = (np.arange(c) % k).astype(np.int32)
    return h, q, y, fp, owners


def _run_epochs(h, q, y, fp, owners, cfg, epochs):
    jstate = jam.make_am_state(jnp.asarray(fp), jnp.asarray(owners),
                               cfg.threshold)
    pcfg = types.MemhdConfig(**dataclasses.asdict(cfg))
    tstate = am.make_am_state(torch.from_numpy(fp), torch.from_numpy(owners),
                              cfg.threshold)
    jb = jqail.prebatch(jnp.asarray(h), jnp.asarray(q), jnp.asarray(y),
                        cfg.batch_size)
    tb = qail.prebatch(torch.from_numpy(h), torch.from_numpy(q),
                       torch.from_numpy(y), cfg.batch_size)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(n(b), np.asarray(a))
    for _ in range(epochs):
        jstate, jmiss = jqail.qail_epoch_scan(jstate, cfg, *jb,
                                              refresh_every=2)
        tstate, tmiss = qail.qail_epoch_scan(tstate, pcfg, *tb,
                                             refresh_every=2)
    return jstate, tstate, float(jmiss), float(tmiss)


def test_qail_epoch_bit_exact_under_dyadic_conditions():
    # Dyadic H and initial AM, lr = 2^-4, normalize="none", D*C = 2^14:
    # every Eq.-(6) sum and the global mean are exact in any order, so
    # the one-hot product and the reference's scatter agree bit for bit.
    cfg = jtypes.MemhdConfig(dim=128, columns=128, classes=10, lr=0.0625,
                             normalize="none", batch_size=32)
    args = _qail_inputs(9, 150, 128, 128, 10, lr_feats=True)
    jstate, tstate, jmiss, tmiss = _run_epochs(*args, cfg, epochs=2)
    np.testing.assert_array_equal(n(tstate["binary"]),
                                  np.asarray(jstate["binary"]))
    np.testing.assert_array_equal(n(tstate["fp"]), np.asarray(jstate["fp"]))
    assert tmiss == jmiss


def test_qail_epoch_defaults_agree_on_999_per_mille_of_cells():
    # Default l2 normalization and lr = 0.02: float rounding of the
    # Eq.-(6) sums and the norms differs by order, so cells near the
    # threshold may flip; >= 99.9 % of the binary AM must agree.
    cfg = jtypes.MemhdConfig(dim=128, columns=128, classes=10,
                             batch_size=32)
    args = _qail_inputs(10, 150, 128, 128, 10, lr_feats=False)
    jstate, tstate, _, _ = _run_epochs(*args, cfg, epochs=2)
    agree = (n(tstate["binary"]) == np.asarray(jstate["binary"])).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(n(tstate["fp"]), np.asarray(jstate["fp"]),
                               rtol=1e-4, atol=1e-4)


ENGINES = ["scan_kernel", "sequential", "batched", "hostloop",
           "fold_feedback"]


def _engine(mod, name, state, cfg, h, q, y):
    """One engine of ``mod`` (the JAX or the port's qail) over (h, q, y):
    returns (state, miss) with miss a float (NaN for the sequential
    epoch, which has none)."""
    if name == "scan_kernel":
        hb, qb, yb, mask = mod.prebatch(h, q, y, cfg.batch_size)
        st, miss = mod.qail_epoch_scan(state, cfg, hb, qb, yb, mask,
                                       refresh_every=2, use_kernel=True)
        return st, float(miss)
    if name == "sequential":
        return mod.qail_epoch_sequential(state, cfg, h, q, y), float("nan")
    if name == "batched":
        st, miss = mod.qail_epoch_batched(state, cfg, h, q, y,
                                          refresh_every=2)
        return st, float(miss)
    if name == "hostloop":
        return mod.qail_epoch_hostloop(state, cfg, h, q, y, refresh_every=2)
    return mod.fold_feedback(state, cfg, h, q, y, epochs=2, refresh_every=2)


@pytest.mark.parametrize("engine", ENGINES)
def test_qail_engines_bit_exact_under_dyadic_conditions(engine):
    # The dyadic conditions of the scan test above: every Eq.-(6) sum and
    # the global mean are exact in any order, so each port engine must
    # equal its JAX counterpart bit for bit (the kernel route against
    # the Pallas kernel in interpret mode). 150 rows, batch 32: a ragged
    # last batch; refresh every 2 batches: a trailing finalize.
    cfg = jtypes.MemhdConfig(dim=128, columns=128, classes=10, lr=0.0625,
                             normalize="none", batch_size=32)
    pcfg = types.MemhdConfig(**dataclasses.asdict(cfg))
    h, q, y, fp, owners = _qail_inputs(21, 150, 128, 128, 10, lr_feats=True)
    jstate = jam.make_am_state(jnp.asarray(fp), jnp.asarray(owners))
    tstate = am.make_am_state(torch.from_numpy(fp), torch.from_numpy(owners))
    jst, jmiss = _engine(jqail, engine, jstate, cfg, jnp.asarray(h),
                         jnp.asarray(q), jnp.asarray(y))
    tst, tmiss = _engine(qail, engine, tstate, pcfg, torch.from_numpy(h),
                         torch.from_numpy(q), torch.from_numpy(y))
    np.testing.assert_array_equal(n(tst["fp"]), np.asarray(jst["fp"]))
    np.testing.assert_array_equal(n(tst["binary"]), np.asarray(jst["binary"]))
    assert tmiss == jmiss or (np.isnan(tmiss) and np.isnan(jmiss))
    # The caller's state is never modified.
    np.testing.assert_array_equal(n(tstate["fp"]), fp)


def test_select_update_targets_matches():
    rng = np.random.default_rng(22)
    owners = np.array([0, 0, 1, 1, 2, 2], np.int32)
    for _ in range(50):
        sims = rng.integers(-3, 4, size=6).astype(np.float32)  # many ties
        label = int(rng.integers(0, 4))  # class 3 owns no centroid
        got = qail.select_update_targets(torch.from_numpy(sims),
                                         torch.from_numpy(owners), label, 4)
        want = jqail.select_update_targets(jnp.asarray(sims),
                                           jnp.asarray(owners), label, 4)
        assert [bool(got[0]), int(got[1]), int(got[2])] == [
            bool(want[0]), int(want[1]), int(want[2])]


# -- checkpointing --------------------------------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(3, 4)).astype(np.float32)),
            "n": [torch.arange(5, dtype=torch.int32), np.float32(seed)]}


def test_checkpoint_roundtrip_keep_k_and_latest(tmp_path):
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2))
    for step in (1, 2, 3):
        mgr.save(step, _tree(step), extra={"curve": [step]})
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    assert os.readlink(tmp_path / "latest") == "step_0000000003"
    step, tree, extra = mgr.restore(_tree(0))
    assert step == 3 and extra == {"curve": [3]}
    want = _tree(3)
    assert torch.equal(tree["w"], want["w"]) and tree["w"].dtype == torch.float32
    assert torch.equal(tree["n"][0], want["n"][0])
    assert tree["n"][0].dtype == torch.int32
    assert float(tree["n"][1]) == 3.0  # a numpy leaf comes back as numpy
    step, tree, _ = mgr.restore(_tree(0), step=2)
    assert step == 2 and torch.equal(tree["w"], _tree(2)["w"])


def test_checkpoint_torn_file_and_tmp_dir_are_skipped(tmp_path):
    import json as _json
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=5))
    mgr.save(1, _tree(1))
    d2 = mgr.save(2, _tree(2))
    # A torn leaf file in the newest checkpoint: restore falls back to 1.
    meta = _json.load(open(os.path.join(d2, "manifest.json")))
    leaf = os.path.join(d2, meta["files"]["w"]["file"])
    with open(leaf, "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\x00\x00\x00\x01")
    step, tree, _ = mgr.restore(_tree(0))
    assert step == 1 and torch.equal(tree["w"], _tree(1)["w"])
    # A crashed writer's .tmp directory is ignored, then removed by the
    # next save; a template key the checkpoint lacks skips it too.
    os.makedirs(tmp_path / "step_0000000009.tmp")
    assert mgr.all_steps() == [1, 2]
    assert mgr.restore({"other": torch.zeros(2)})[0] is None
    mgr.save(3, _tree(3))
    assert not (tmp_path / "step_0000000009.tmp").exists()
    assert mgr.restore(_tree(0))[0] == 3


def test_train_state_round_trip_and_reference_layout(tmp_path):
    # The port's MemhdTrainState uses the reference's leaf keys, so each
    # package restores the other's checkpoint of the same state.
    from repro.checkpoint import CheckpointConfig as JConfig
    from repro.checkpoint import CheckpointManager as JManager
    from repro.core.memhd import MemhdTrainState as JState
    from repro_torch import convert
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core.memhd import MemhdTrainState
    h, q, y, fp, owners = _qail_inputs(23, 8, 16, 8, 3, lr_feats=True)
    jstate = JState.create(jam.make_am_state(jnp.asarray(fp),
                                             jnp.asarray(owners)), 4)
    tstate = convert.train_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.am_state.items()},
        int(jstate.epoch), device="cpu")
    assert tstate.epoch.dtype == torch.int32 and int(tstate.epoch) == 4
    JManager(JConfig(str(tmp_path / "jax"))).save(4, jstate)
    CheckpointManager(CheckpointConfig(str(tmp_path / "port"))).save(
        4, tstate)
    template = MemhdTrainState.create(am.make_am_state(
        torch.zeros((8, 16)), torch.zeros(8, dtype=torch.int32)))
    jtemplate = JState.create(jam.make_am_state(
        jnp.zeros((8, 16)), jnp.zeros(8, jnp.int32)))
    for d in ("jax", "port"):
        step, got, _ = CheckpointManager(CheckpointConfig(
            str(tmp_path / d))).restore(template)
        assert step == 4 and int(got.epoch) == 4
        for k, v in tstate.am_state.items():
            assert torch.equal(got.am_state[k], v)
            assert got.am_state[k].dtype == v.dtype
        step, jgot, _ = JManager(JConfig(str(tmp_path / d))).restore(
            jtemplate)
        assert step == 4
        for k, v in tstate.am_state.items():
            np.testing.assert_array_equal(np.asarray(jgot.am_state[k]),
                                          n(v))


def test_fit_crash_and_resume_is_bit_exact(tmp_path):
    # A fit that stops after epoch 2 and is resumed to epoch 4 lands on
    # the AM, and the miss curve, of an uninterrupted 4-epoch fit.
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import MemhdModel
    ds = hdc.load_dataset("mnist", train_per_class=30, test_per_class=5,
                          device="cpu")
    enc = types.EncoderConfig(features=784, dim=128)
    amc = types.MemhdConfig(dim=128, columns=64, classes=10,
                            kmeans_iters=3, batch_size=64)

    def fit(d, epochs):
        mgr = CheckpointManager(CheckpointConfig(str(tmp_path / d), keep=2))
        m = MemhdModel.create(0, enc, amc, device="cpu")
        return m.fit(1, ds.train_x, ds.train_y, epochs=epochs, ckpt=mgr,
                     ckpt_every=2, eval_feats=ds.test_x,
                     eval_labels=ds.test_y), mgr

    fit("crash", 2)
    (resumed, rhist), mgr = fit("crash", 4)
    (clean, chist), _ = fit("clean", 4)
    for k in ("fp", "binary", "centroid_class"):
        assert torch.equal(resumed.am_state[k], clean.am_state[k])
    assert rhist == chist
    assert [r["epoch"] for r in rhist["curve"]] == [0, 1, 2, 3, 4]
    assert mgr.all_steps() == [2, 4]
    # A finished run resumes to a no-op.
    (again, hist2), _ = fit("clean", 4)
    assert torch.equal(again.am_state["fp"], clean.am_state["fp"])
    assert hist2 == chist


def test_qail_not_ported_options_raise():
    cfg = types.MemhdConfig(dim=8, columns=8, classes=2)
    state = am.make_am_state(torch.zeros((8, 8)),
                             torch.zeros(8, dtype=torch.int32))
    hb = torch.zeros((1, 4, 8))
    yb = torch.zeros((1, 4), dtype=torch.int32)
    for kw in ({"cell_bits": 4}, {"sim": object()}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            qail.qail_epoch_scan(state, cfg, hb, hb, yb, torch.ones((1, 4)),
                                 **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        qail.qail_batch_delta(state, cfg, hb[0], hb[0], yb[0])
    # use_kernel=True, the sequential and host-loop epochs and
    # fold_feedback are ported: on CPU tensors they run the plain path.
    for fn in (qail.qail_epoch_sequential, qail.qail_epoch_hostloop,
               qail.fold_feedback):
        fn(state, cfg, hb[0], hb[0], yb[0])
    qail.qail_epoch_scan(state, cfg, hb, hb, yb, torch.ones((1, 4)),
                         use_kernel=True)


def test_batched_accuracy_pads_ragged_tail_with_minus_one_labels():
    x = torch.arange(10, dtype=torch.float32)[:, None]
    y = torch.arange(10) % 3
    seen = []

    def predict(rows):
        seen.append(rows.shape[0])
        return rows[:, 0].long() % 3

    assert evaluate.batched_accuracy(predict, x, y, batch=4) == 1.0
    assert seen == [4, 4, 4]  # the tail of 2 padded to the batch shape
    wrong = evaluate.batched_accuracy(lambda r: r[:, 0].long() * 0, x, y,
                                      batch=4)
    assert wrong == pytest.approx(4 / 10)
