"""The port's Table-I baselines and what they need, against the JAX
package on the CPU: the ``id_level`` encoder, BasicHDC / QuantHD / LeHDC /
SearcHD, random-sampling AM init, ``MemhdHead`` and the paper's named
configs.

Operands are numpy arrays from a seed, fed to both packages; the
reference's ``jax.random`` draws (encoder params, LeHDC's initial
weights, SearcHD's uniforms, the random init's numpy seed) cross into
the port as arrays (``BaselineDraws``, ``init_seed``). Exact where the
arithmetic is exact: every id_level term is ±1 and |H| <= f < 2^24, and
dyadic features and lr keep every sum exact in any order. The stated
tolerances cover the rest.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import memhd_paper as jpaper  # noqa: E402
from repro.core import baselines as jb  # noqa: E402
from repro.core import encoding as jenc  # noqa: E402
from repro.core import init as jinit  # noqa: E402
from repro.core import types as jtypes  # noqa: E402
from repro.core.head import MemhdHead as JHead  # noqa: E402
from repro.core.memhd import MemhdModel as JModel  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import memhd_paper as tpaper  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.core import encoding, init, types  # noqa: E402
from repro_torch.core.head import MemhdHead  # noqa: E402

KINDS = ("basic", "quanthd", "lehdc", "searchd")


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def data():
    """Dyadic features on a 2^-8 grid (50 rows a class, f = 100, k = 5)
    plus their labels: projection sums stay exact in float32."""
    rng = np.random.default_rng(0)
    k, per, f = 5, 50, 100
    y = np.repeat(np.arange(k), per)
    centers = rng.random((k, f))
    x = np.clip(centers[y] + 0.25 * rng.standard_normal((k * per, f)), 0, 1)
    x = (np.round(x * 256) / 256).astype(np.float32)
    perm = rng.permutation(k * per)
    return x[perm], y[perm].astype(np.int32)


def ref_draws(key, cfg, features):
    """The reference fitter's draws, as numpy: its encoder params and, by
    kind, LeHDC's initial weights or SearcHD's uniforms."""
    k_enc, k2 = jax.random.split(key)
    enc_cfg = jb._encoder_cfg(cfg, features)
    params = {k: np.asarray(v)
              for k, v in jenc.init_encoder(k_enc, enc_cfg).items()}
    w = u = None
    if cfg.kind == "lehdc":
        w = np.asarray(0.01 * jax.random.normal(k2, (cfg.classes, cfg.dim)))
    if cfg.kind == "searchd":
        u = np.asarray(jax.random.uniform(
            k2, (cfg.classes, cfg.n_models, cfg.dim)))
    return tb.BaselineDraws(params, w, u)


def port_cfg(cfg):
    return types.BaselineConfig(**dataclasses.asdict(cfg))


# -- the id_level encoder -----------------------------------------------------

@pytest.mark.parametrize("f", [10, 100, 784])
@pytest.mark.parametrize("levels", [2, 16, 256])
def test_encode_id_level_bit_exact_at_any_chunk(f, levels):
    # Every term is ±1 (0 for the reference's padded columns) and
    # |H| <= f < 2^24: bit-exact, whatever the chunk, f no multiple of it.
    cfg = jtypes.EncoderConfig(kind="id_level", features=f, dim=96,
                               levels=levels)
    params = jenc.init_id_level(jax.random.key(f + levels), cfg)
    tparams = {k: t(np.asarray(v)) for k, v in params.items()}
    rng = np.random.default_rng(f * levels)
    x = rng.random((2, 3, f)).astype(np.float32)
    x[0, 0, :3] = [-0.5, 1.5, 0.5]  # clipped, and a rounding tie
    for chunk in (1, 7, 128, 1000):
        want = np.asarray(jenc.encode_id_level(params, x, chunk=chunk))
        got = n(encoding.encode_id_level(tparams, t(x), chunk=chunk))
        assert got.shape == (2, 3, 96)
        np.testing.assert_array_equal(got, want)


def test_encode_id_level_row_blocks_are_exact(monkeypatch):
    # A gather buffer cut to one row per step changes no bit.
    cfg = jtypes.EncoderConfig(kind="id_level", features=30, dim=64,
                               levels=8)
    params = jenc.init_id_level(jax.random.key(3), cfg)
    x = np.random.default_rng(3).random((9, 30)).astype(np.float32)
    want = np.asarray(jenc.encode_id_level(params, x))
    monkeypatch.setattr(encoding, "GATHER_BYTES", 1)
    got = encoding.encode_id_level(
        {k: t(np.asarray(v)) for k, v in params.items()}, t(x))
    np.testing.assert_array_equal(n(got), want)


def test_quantize_features_rounds_half_to_even_as_the_reference():
    x = np.array([[-1.0, 0.0, 0.125, 0.375, 0.5, 0.625, 1.0, 2.0]],
                 np.float32)
    for levels in (2, 5, 256):
        np.testing.assert_array_equal(
            n(encoding.quantize_features(t(x), levels)),
            np.asarray(jenc.quantize_features(x, levels)))


@pytest.mark.parametrize("levels,dim", [(2, 64), (16, 1000), (256, 512)])
def test_level_vectors_are_nested_thermometer_codes(levels, dim):
    # The port's own draws: L_0 and L_{L-1} differ at D // 2 positions,
    # level i at floor(i * (D // 2) / (L - 1)), and the flipped sets nest.
    cfg = types.EncoderConfig(kind="id_level", features=3, dim=dim,
                              levels=levels)
    params = encoding.init_encoder(torch.Generator().manual_seed(7), cfg)
    lv = n(params["levels"])
    assert lv.shape == (levels, dim) and set(np.unique(lv)) <= {-1.0, 1.0}
    assert set(np.unique(n(params["ids"]))) <= {-1.0, 1.0}
    flips = lv != lv[0]
    for i in range(levels):
        assert flips[i].sum() == (i * (dim // 2)) // (levels - 1)
    assert flips[-1].sum() == dim // 2
    assert (flips[:-1] <= flips[1:]).all()  # nested


# -- the four baselines -------------------------------------------------------

def _fit_pair(kind, data, **cfg_kw):
    x, y = data
    cfg = jtypes.BaselineConfig(kind=kind, dim=256, classes=5, n_models=4,
                                epochs=3, **cfg_kw)
    key = jax.random.key(11)
    ref = jb.fit_baseline(key, cfg, x, y)
    port = tb.fit_baseline(0, port_cfg(cfg), x, y,
                           draws=ref_draws(key, cfg, x.shape[1]),
                           device="cpu")
    return cfg, ref, port


def test_fit_basic_bit_exact(data):
    _, ref, port = _fit_pair("basic", data)
    np.testing.assert_array_equal(n(port.am), np.asarray(ref.am))
    np.testing.assert_array_equal(n(port.owners), np.asarray(ref.owners))
    assert port.enc_cfg == types.EncoderConfig(
        **dataclasses.asdict(ref.enc_cfg))


def test_fit_quanthd_bit_exact_at_a_dyadic_lr(data):
    # lr = 2^-4 on integer class sums: every update exact in any order.
    _, ref, port = _fit_pair("quanthd", data, lr=0.0625)
    np.testing.assert_array_equal(n(port.am), np.asarray(ref.am))
    assert port.enc_cfg.kind == "id_level"


def test_quanthd_epoch_within_rounding_at_lr_005(data):
    # lr = 0.05: the reference adds a cell's m Eq.-(2) terms to it one by
    # one (scatter-adds), the port sums them first (one-hot products).
    # Recursive summation of m + 1 values errs by at most m * 2^-24 *
    # sum|values|, so the two may differ by (m + 1) * 2^-23 * (|fp| + the
    # cell's sum of |terms|).
    x, y = data
    cfg = jtypes.BaselineConfig(kind="quanthd", dim=256, classes=5)
    draws = ref_draws(jax.random.key(5), cfg, x.shape[1])
    enc_cfg = jb._encoder_cfg(cfg, x.shape[1])
    h = np.asarray(jenc.encode(
        {k: jnp.asarray(v) for k, v in draws.enc_params.items()},
        enc_cfg, x))
    q = np.where(h >= 0, 1.0, -1.0).astype(np.float32)
    fp = np.asarray(jb._class_sums(jnp.asarray(h), jnp.asarray(y), 5))
    # A random binary AM snapshot: most rows mispredict and update.
    binary = np.random.default_rng(5).choice(
        [-1.0, 1.0], size=fp.shape).astype(np.float32)
    want = np.asarray(jb._quanthd_epoch(jnp.asarray(fp), jnp.asarray(binary),
                                        jnp.asarray(q), jnp.asarray(y),
                                        5, 0.05))
    got = n(tb._quanthd_epoch(t(fp), t(binary), t(q), t(y).long(), 5, 0.05))
    preds = np.argmax(q @ binary.T, axis=-1)
    coef = np.abs(0.05 * q) * (preds != y)[:, None]
    terms = np.abs(fp).astype(np.float64)
    np.add.at(terms, y, coef)
    np.add.at(terms, preds, coef)
    miss = preds != y
    m = (np.bincount(y[miss], minlength=5)
         + np.bincount(preds[miss], minlength=5))[:, None]
    assert m.max() > 10
    assert (np.abs(got - want) <= (m + 1) * 2.0 ** -23 * terms).all()
    assert (got != fp).any()  # the epoch updated something


def test_fit_lehdc_within_tolerance(data):
    # Three epochs of momentum SGD through autograd against jax.grad:
    # float rounding of the logits, softmax and gradient may differ, so
    # the float weights agree within 1e-5, and the binary AM wherever
    # |w| exceeds that.
    x, y = data
    cfg = jtypes.BaselineConfig(kind="lehdc", dim=256, classes=5, epochs=3)
    draws = ref_draws(jax.random.key(13), cfg, x.shape[1])
    enc_cfg = jb._encoder_cfg(cfg, x.shape[1])
    h = jenc.encode({k: jnp.asarray(v) for k, v in draws.enc_params.items()},
                    enc_cfg, x)
    q = np.asarray(jenc.binarize_query(h))
    jw, jv = jnp.asarray(draws.lehdc_weights), None
    jv = jnp.zeros_like(jw)
    tw, tv = t(draws.lehdc_weights), torch.zeros(5, 256)
    for _ in range(cfg.epochs):
        for b in range(0, q.shape[0], 64):
            jw, jv, jl = jb._lehdc_step(jw, jv, jnp.asarray(q[b:b + 64]),
                                        jnp.asarray(y[b:b + 64]), 5,
                                        cfg.lr, 0.9)
            tw, tv, tl = tb._lehdc_step(tw, tv, t(q[b:b + 64]),
                                        t(y[b:b + 64]).long(), cfg.lr, 0.9)
            assert abs(float(tl) - float(jl)) <= 1e-5
    jw = np.asarray(jw)
    np.testing.assert_allclose(n(tw), jw, rtol=0, atol=1e-5)
    far = np.abs(jw) > 1e-5
    np.testing.assert_array_equal(n(tb._sign(tw))[far],
                                  np.asarray(jb._sign(jnp.asarray(jw)))[far])
    assert np.abs(jw - draws.lehdc_weights).max() > 1e-3  # it trained
    # The fitter end to end: equal binary AM wherever |w| > 1e-5.
    ref = jb.fit_lehdc(jax.random.key(13), cfg, x, y, batch=64)
    port = tb.fit_lehdc(0, port_cfg(cfg), x, y, batch=64, draws=draws,
                        device="cpu")
    np.testing.assert_array_equal(n(port.am)[far], np.asarray(ref.am)[far])


def test_fit_searchd_equal_away_from_the_firing_threshold(data):
    # The same uniforms against p_fire: a cell may differ only where
    # |u - p_fire| <= 1e-6 (the population std, the sigmoid and the
    # product round differently).
    x, y = data
    cfg, ref, port = _fit_pair("searchd", data)
    draws = ref_draws(jax.random.key(11), cfg, x.shape[1])
    h = jenc.encode({k: jnp.asarray(v) for k, v in draws.enc_params.items()},
                    jb._encoder_cfg(cfg, x.shape[1]), x)
    sums = jb._class_sums(h, jnp.asarray(y), cfg.classes)
    p_fire = np.asarray(jax.nn.sigmoid(
        3.0 * sums / (sums.std(axis=-1, keepdims=True) + 1e-8)))
    far = (np.abs(draws.searchd_uniforms - p_fire[:, None, :]) > 1e-6
           ).reshape(cfg.classes * cfg.n_models, cfg.dim)
    assert far.mean() > 0.99
    np.testing.assert_array_equal(n(port.am)[far], np.asarray(ref.am)[far])
    np.testing.assert_array_equal(n(port.owners), np.asarray(ref.owners))
    assert n(port.am).shape == (cfg.classes * cfg.n_models, cfg.dim)


@pytest.mark.parametrize("kind", KINDS)
def test_score_predict_and_memory_bits(kind, data):
    # Table I: EM bits f*D (projection) or (f + L)*D (id_level), AM bits
    # k*D, or k*N*D for SearcHD; predictions equal on every row.
    x, y = data
    cfg, ref, port = _fit_pair(kind, data, lr=0.0625)
    assert port.memory_bits == ref.memory_bits
    enc_bits = (100 * 256 if kind == "basic" else (100 + 256) * 256)
    am_bits = 5 * 256 * (4 if kind == "searchd" else 1)
    assert port.memory_bits == enc_bits + am_bits
    assert port.memory_kb == port.memory_bits / 8 / 1024
    # The reference's AM in the port's model: the same predictions.
    leaves = {k: np.asarray(v) for k, v in ref.enc_params.items()}
    same = convert.baseline_from_numpy(
        leaves, np.asarray(ref.am), np.asarray(ref.owners),
        dataclasses.asdict(cfg), device="cpu")
    np.testing.assert_array_equal(n(same.predict(t(x))),
                                  np.asarray(ref.predict(x)))
    assert same.score(t(x), t(y), batch=64) == ref.score(x, y, batch=64)
    assert 0.0 <= port.score(x, y) <= 1.0


def test_fitters_draw_their_own_and_run_end_to_end(data):
    # Without draws the port draws from its generator: seeded, so the
    # same seed gives the same model; every kind learns the easy data.
    x, y = data
    for kind in KINDS:
        cfg = types.BaselineConfig(kind=kind, dim=512, classes=5,
                                   n_models=4, epochs=3)
        a = tb.fit_baseline(3, cfg, x, y, device="cpu")
        b = tb.fit_baseline(3, cfg, x, y, device="cpu")
        assert torch.equal(a.am, b.am)
        assert a.score(x, y) > 0.5, (kind, a.score(x, y))
    with pytest.raises(ValueError, match="generator"):
        tb.fit_basic(torch.Generator(), cfg, x, y, device="meta")


# -- random-sampling init -----------------------------------------------------

def ref_seed(key):
    return int(np.asarray(jax.random.key_data(key)).sum() % (2 ** 31))


def test_random_sampling_init_bit_exact_with_the_reference_seed():
    rng = np.random.default_rng(4)
    y = np.repeat(np.arange(3), [2, 40, 9]).astype(np.int32)  # 2 < budget
    h = rng.standard_normal((y.size, 32)).astype(np.float32)
    cfg = jtypes.MemhdConfig(dim=32, columns=17, classes=3)
    key = jax.random.key(9)
    jfp, jown = jinit.random_sampling_init(key, cfg, jnp.asarray(h),
                                           jnp.asarray(y))
    tfp, town = init.random_sampling_init(
        None, types.MemhdConfig(**dataclasses.asdict(cfg)), t(h), t(y),
        seed=ref_seed(key))
    np.testing.assert_array_equal(n(tfp), np.asarray(jfp))
    np.testing.assert_array_equal(n(town), np.asarray(jown))
    assert town.dtype == torch.int32 and n(town).tolist().count(0) == 6
    # Its own seed, from a generator: seeded too.
    a = init.random_sampling_init(torch.Generator().manual_seed(1),
                                  types.MemhdConfig(**dataclasses.asdict(cfg)),
                                  t(h), t(y))
    b = init.random_sampling_init(torch.Generator().manual_seed(1),
                                  types.MemhdConfig(**dataclasses.asdict(cfg)),
                                  t(h), t(y))
    assert torch.equal(a[0], b[0])


def test_fit_with_random_init_end_to_end(data):
    # Dyadic features, lr = 2^-4, normalize="none", D*C a power of two:
    # the sampled rows and every QAIL sum are exact, so the whole fit
    # equals the reference's bit for bit.
    x, y = data
    enc = jtypes.EncoderConfig(features=100, dim=128)
    amc = jtypes.MemhdConfig(dim=128, columns=32, classes=5, lr=0.0625,
                             normalize="none", batch_size=32, epochs=3)
    jm = JModel.create(jax.random.key(0), enc, amc)
    k_fit = jax.random.key(1)
    jm, jhist = jm.fit(k_fit, x, y, init_method="random")
    zeros = {"fp": np.zeros((32, 128), np.float32),
             "binary": np.zeros((32, 128), np.float32),
             "centroid_class": np.zeros(32, np.int32)}
    tm = convert.model_from_numpy(
        {"projection": np.asarray(jm.enc_params["projection"])}, zeros,
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    tm, thist = tm.fit(0, x, y, init_method="random",
                       init_seed=ref_seed(k_fit))
    for k in ("fp", "binary", "centroid_class"):
        np.testing.assert_array_equal(n(tm.am_state[k]),
                                      np.asarray(jm.am_state[k]))
    assert thist["init"] == jhist["init"] == []
    assert [r["train_miss"] for r in thist["curve"]] == [
        r["train_miss"] for r in jhist["curve"]]
    with pytest.raises(ValueError, match="init method"):
        tm.initialize_am(0, x, y, method="kmeans")


# -- MemhdHead and the paper's configs ----------------------------------------

def test_memhd_head_matches_the_reference(data):
    # Pooling, geometry, and a head built on the reference's projection
    # and AM predicts as the reference's head does.
    x, y = data
    hidden = np.random.default_rng(2).standard_normal(
        (4, 6, 100)).astype(np.float32)
    np.testing.assert_allclose(n(MemhdHead.pool(t(hidden))),
                               np.asarray(JHead.pool(jnp.asarray(hidden))),
                               rtol=1e-6, atol=1e-6)
    jh = JHead.create(jax.random.key(0), 100, 5, dim=128, columns=32,
                      epochs=2, lr=0.0625, normalize="none", batch_size=32)
    jh, _ = jh.fit(jax.random.key(1), x, y)
    th = MemhdHead.create(0, 100, 5, dim=128, columns=32, device="cpu",
                          epochs=2, lr=0.0625, normalize="none",
                          batch_size=32)
    assert th.model.am_cfg == types.MemhdConfig(
        **dataclasses.asdict(jh.model.am_cfg))
    th, hist = th.fit(1, x, y)
    assert len(hist["curve"]) == 2 and th.score(x, y) > 0.5
    assert th.memory_kb == jh.memory_kb == (100 + 32) * 128 / 8 / 1024
    same = MemhdHead(convert.model_from_numpy(
        {"projection": np.asarray(jh.model.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jh.model.am_state.items()},
        dataclasses.asdict(jh.model.enc_cfg),
        dataclasses.asdict(jh.model.am_cfg), device="cpu"))
    np.testing.assert_array_equal(n(same.predict(x)),
                                  np.asarray(jh.predict(x)))
    assert same.score(x, y) == jh.score(x, y)


@pytest.mark.parametrize("dataset,geometry",
                         list(jpaper.list_paper_points()))
def test_paper_config_field_by_field(dataset, geometry):
    jenc_cfg, jam_cfg = jpaper.paper_config(dataset, geometry)
    tenc_cfg, tam_cfg = tpaper.paper_config(dataset, geometry)
    assert dataclasses.asdict(tenc_cfg) == dataclasses.asdict(jenc_cfg)
    assert dataclasses.asdict(tam_cfg) == dataclasses.asdict(jam_cfg)
    kw = dict(batch_size=256, kmeans_iters=25, epochs=7)
    assert (dataclasses.asdict(tpaper.paper_config(dataset, geometry,
                                                   **kw)[1])
            == dataclasses.asdict(jpaper.paper_config(dataset, geometry,
                                                      **kw)[1]))


def test_paper_tables_and_unknown_points():
    assert tpaper.GRIDS == jpaper.GRIDS
    assert tpaper.FLAGSHIP == jpaper.FLAGSHIP
    assert tpaper.DEFAULT_R == jpaper.DEFAULT_R
    assert tpaper.DEFAULT_LR == jpaper.DEFAULT_LR
    assert list(tpaper.list_paper_points()) == list(
        jpaper.list_paper_points())
    for ds in jpaper.GRIDS:
        assert (dataclasses.asdict(tpaper.paper_config(ds)[1])
                == dataclasses.asdict(jpaper.paper_config(ds)[1]))
    for mod in (jpaper, tpaper):
        with pytest.raises(KeyError, match="not a paper geometry"):
            mod.paper_config("isolet", "64x64")
        with pytest.raises(KeyError):
            mod.paper_config("cifar")
