"""The port's online serving (``repro_torch.serve``) against the JAX
package's, on the CPU.

The batching policy, the bucket grid and the EWMA service model decide
as the reference's over seeded grids; the numpy stream helpers give the
same events; class growth and the streaming fold match the
single-device reference (the binary AM bit-exact under dyadic
conditions); every request the engine serves equals the plain predict of
the generation that served it, a batch in flight across a swap finishes
on the old artifact, a same-C swap keeps ``swap_signature``, and the
``serve_online`` CLI runs end to end with zero steady-state rebuilds.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EncoderConfig as JEnc  # noqa: E402
from repro.core import MemhdConfig as JAm  # noqa: E402
from repro.core import MemhdModel as JModel  # noqa: E402
from repro.core import am as jam  # noqa: E402
from repro.data import load_dataset as jload  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve import stream as jstream  # noqa: E402
from repro.serve import updater as jupdater  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Arrival, OnlineEngine, OnlineRequest, ServiceModel, StreamingUpdater,
    apply_drift, batch_buckets, feedback_burst, merge_events, plan_batch,
    poisson_arrivals,
)
from repro_torch.serve import stream as tstream  # noqa: E402


def n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- the batching policy ------------------------------------------------------

def _queue(mod, rng, length):
    return [mod.OnlineRequest(
        rid=i, feats=np.zeros((int(rng.integers(1, 9)), 3), np.float32),
        t_arrival=float(rng.uniform(0, 0.05)),
        deadline_ms=(None if rng.random() < 0.3
                     else float(rng.uniform(1, 40))))
        for i in range(length)]


@pytest.mark.parametrize("seed", range(4))
def test_plan_batch_decides_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    decisions = []
    for _ in range(300):
        length = int(rng.integers(0, 12))
        state = rng.bit_generator.state
        jq = _queue(jstream, rng, length)
        rng.bit_generator.state = state
        tq = _queue(tstream, rng, length)
        kw = dict(max_batch=int(rng.choice([8, 16, 32])),
                  inflight_eta_s=float(rng.choice([0.0, 0.004, 0.02])),
                  margin_s=float(rng.choice([0.0, 0.002])),
                  max_wait_s=float(rng.choice([0.005, 0.05])),
                  flush=bool(rng.random() < 0.2))
        now = float(rng.uniform(0, 0.1))
        per_row = float(rng.choice([1e-5, 1e-3]))

        def est(rows):
            return per_row * rows

        want = jengine.plan_batch(jq, now, estimate_rows_s=est, **kw)
        got = plan_batch(tq, now, estimate_rows_s=est, **kw)
        assert got == want
        decisions.append(got)
    assert 0 in decisions and max(decisions) > 1  # both outcomes covered


def test_batch_buckets_and_service_model_match():
    for tile in (1, 4, 8, 24):
        for max_batch in (1, 7, 8, 100, 256, 1000):
            assert (batch_buckets(tile, max_batch)
                    == jengine.batch_buckets(tile, max_batch))
    for mod in (jengine, None):
        with pytest.raises(ValueError):
            (mod.batch_buckets if mod else batch_buckets)(0, 8)
    rng = np.random.default_rng(7)
    jm, tm = jengine.ServiceModel(), ServiceModel()
    assert tm.estimate(64) == jm.estimate(64) == 0.005  # blind default
    for _ in range(200):
        b = int(rng.choice([8, 16, 32, 64, 128]))
        if rng.random() < 0.5:
            s = float(rng.exponential(0.003))
            jm.observe(b, s)
            tm.observe(b, s)
        q = int(rng.choice([8, 16, 24, 32, 48, 256]))
        assert tm.estimate(q) == jm.estimate(q)


# -- the stream helpers -------------------------------------------------------

def _events_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert type(x).__name__ == type(y).__name__ and x.t == y.t
        if type(x).__name__ == "Arrival":
            rx, ry = x.request, y.request
            assert (rx.rid, rx.t_arrival, rx.deadline_ms) == (
                ry.rid, ry.t_arrival, ry.deadline_ms)
            np.testing.assert_array_equal(rx.feats, ry.feats)
            np.testing.assert_array_equal(rx.labels, ry.labels)
        else:
            np.testing.assert_array_equal(x.feats, y.feats)
            np.testing.assert_array_equal(x.labels, y.labels)
            assert x.fold == y.fold


def test_stream_helpers_give_the_same_events():
    rng = np.random.default_rng(3)
    pool = rng.random((60, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 60)
    for kw in ({}, {"deadline_ms": 25.0, "classes": [1, 3]},
               {"start": 2.0, "rid_base": 100, "max_size": 3}):
        a = jstream.poisson_arrivals(pool, n_requests=25, rate_qps=400,
                                     labels_pool=labels, seed=9, **kw)
        b = poisson_arrivals(pool, n_requests=25, rate_qps=400,
                             labels_pool=labels, seed=9, **kw)
        _events_equal(a, b)
    fa = jstream.feedback_burst(pool, labels, t=0.5, chunk=7, fold=True)
    fb = feedback_burst(pool, labels, t=0.5, chunk=7, fold=True)
    _events_equal(fa, fb)
    assert [f.fold for f in fb] == [False] * 8 + [True]
    _events_equal(jstream.merge_events(a, fa), merge_events(b, fb))
    for s in (0.0, 0.35, 1.0):
        np.testing.assert_array_equal(apply_drift(pool, s, 5),
                                      jstream.apply_drift(pool, s, 5))
    for bad in (lambda m: m.apply_drift(pool, 1.5),
                lambda m: m.poisson_arrivals(pool, n_requests=1,
                                             rate_qps=0.0),
                lambda m: m.feedback_burst(pool, labels[:3], t=0.0)):
        for mod in (jstream, tstream):
            with pytest.raises(ValueError):
                bad(mod)
    req = OnlineRequest(rid=1, feats=pool[:3], t_arrival=1.0,
                        deadline_ms=20.0)
    assert req.size == 3 and req.t_deadline == pytest.approx(1.02)


# -- models -------------------------------------------------------------------

@pytest.fixture(scope="module")
def ds():
    """The synthetic MNIST on dyadic features (a 2^-8 grid): projection
    sums stay exact, so the folds can be bit-exact."""
    d = jload("mnist", train_per_class=40, test_per_class=20)
    q = lambda a: (np.round(np.asarray(a) * 256) / 256).astype(  # noqa: E731
        np.float32)
    return {"tr_x": q(d.train_x), "tr_y": np.asarray(d.train_y),
            "te_x": q(d.test_x), "te_y": np.asarray(d.test_y),
            "classes": d.classes}


def _fit_pair(ds, classes):
    """A reference model fit on the first ``classes`` classes (dyadic
    lr, no normalization, D * C a power of two, its float AM rounded to a
    2^-8 grid) and the same weights in the port."""
    mask = ds["tr_y"] < classes
    enc = JEnc(kind="projection", features=784, dim=128)
    amc = JAm(dim=128, columns=32, classes=classes, epochs=2,
              kmeans_iters=3, lr=0.0625, normalize="none", batch_size=64)
    jm = JModel.create(jax.random.key(0), enc, amc)
    jm, _ = jm.fit(jax.random.key(1), ds["tr_x"][mask], ds["tr_y"][mask])
    # The float AM on a 2^-8 grid (its k-means means are not dyadic).
    fp = np.round(np.asarray(jm.am_state["fp"]) * 256) / 256
    jm = dataclasses.replace(jm, am_state=jam.make_am_state(
        jnp.asarray(fp), jm.am_state["centroid_class"], amc.threshold))
    tm = convert.model_from_numpy(
        {"projection": np.asarray(jm.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jm.am_state.items()},
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def full(ds):
    return _fit_pair(ds, ds["classes"])


@pytest.fixture(scope="module")
def partial(ds):
    return _fit_pair(ds, ds["classes"] - 1)


def _state_equal(tm, jm, fp_exact=True):
    for k in ("binary", "centroid_class") + (("fp",) if fp_exact else ()):
        np.testing.assert_array_equal(n(tm.am_state[k]),
                                      np.asarray(jm.am_state[k]))
    assert dataclasses.asdict(tm.am_cfg) == dataclasses.asdict(jm.am_cfg)


# -- class growth and the streaming fold --------------------------------------

@pytest.mark.parametrize("per_class", [1, 3])
def test_grow_classes_matches_the_reference(ds, partial, per_class):
    # New rows: numpy means of the same h, rescaled by the mean norm of
    # the float AM, which each side computes in its own summation order:
    # the rows agree within 2^-20 relative, the binary AM bit for bit.
    jm, tm = partial
    known = jm.am_cfg.classes
    new = ds["tr_y"] == known
    x, y = ds["tr_x"][new], ds["tr_y"][new]
    jg = jm.grow_classes(x, y, centroids_per_class=per_class)
    tg = tm.grow_classes(x, y, centroids_per_class=per_class)
    _state_equal(tg, jg, fp_exact=False)
    np.testing.assert_allclose(n(tg.am_state["fp"]),
                               np.asarray(jg.am_state["fp"]),
                               rtol=2.0 ** -20, atol=0)
    assert tg.am_cfg.columns == 32 + per_class
    assert torch.equal(tg.am_state["fp"][:32], tm.am_state["fp"])
    for bad, match in (((x[:2], np.zeros(2, int)), "no labels beyond"),
                       ((x[:2], np.full(2, known + 1)), "contiguous")):
        with pytest.raises(ValueError, match=match):
            tm.grow_classes(*bad)
    with pytest.raises(ValueError, match=">= 1"):
        tm.grow_classes(x, y, centroids_per_class=0)


def test_same_c_fold_is_bit_exact_against_the_reference(ds, full):
    # Dyadic features and AM, lr = 2^-4, no normalization: every QAIL sum
    # is exact, so the fold's float and binary AMs equal the reference's.
    jm, tm = full
    x = apply_drift(ds["tr_x"], 0.5)
    y = ds["tr_y"]
    jup = jupdater.StreamingUpdater(jm, jm.deploy(target="packed"),
                                    fold_epochs=2)
    tup = StreamingUpdater(tm, tm.deploy(target="packed"), fold_epochs=2)
    for up in (jup, tup):
        up.ingest(x, y)
    jr, tr = jup.fold(), tup.fold()
    _state_equal(tup.model, jup.model)
    assert (tr.generation, tr.shape_stable, tr.n_samples,
            tr.n_new_classes) == (jr.generation, jr.shape_stable,
                                  jr.n_samples, jr.n_new_classes)
    assert tr.miss_rate == jr.miss_rate
    np.testing.assert_array_equal(n(tr.artifact.predict(ds["te_x"])),
                                  np.asarray(jr.artifact.predict(
                                      ds["te_x"])))


def test_growth_fold_matches_the_single_device_reference(ds, partial):
    # Growth, then the fold, on both sides (the reference's sharded
    # TestClassAppend cases fail on this tree; this is its single-device
    # path). The grown rows carry the norm rescale's rounding, so the
    # float AM agrees within 2^-18 relative; the binary AM bit for bit.
    jm, tm = partial
    known = jm.am_cfg.classes
    new = ds["tr_y"] == known
    jup = jupdater.StreamingUpdater(jm, jm.deploy(target="packed"),
                                    fold_epochs=2)
    tup = StreamingUpdater(tm, tm.deploy(target="packed"), fold_epochs=2)
    for up in (jup, tup):
        up.ingest(ds["tr_x"][new], ds["tr_y"][new])
    jr, tr = jup.fold(), tup.fold()
    _state_equal(tup.model, jup.model, fp_exact=False)
    np.testing.assert_allclose(n(tup.model.am_state["fp"]),
                               np.asarray(jup.model.am_state["fp"]),
                               rtol=2.0 ** -18, atol=2.0 ** -18)
    assert (tr.n_new_classes, tr.shape_stable) == (1, False) == (
        jr.n_new_classes, jr.shape_stable)
    preds = n(tr.artifact.predict(ds["te_x"]))
    np.testing.assert_array_equal(preds, np.asarray(
        jr.artifact.predict(ds["te_x"])))
    assert (preds[ds["te_y"] == known] == known).any()  # it is served


def test_updater_buffer_policy_and_observability(full, tmp_path):
    _, tm = full
    up = StreamingUpdater(tm, tm.deploy(target="packed"), buffer_cap=10,
                          fold_every=8,
                          events=obs.EventLog(str(tmp_path / "ev.jsonl")))
    assert up.fold() is None and up.generation == 0
    x = np.zeros((6, 784), np.float32)
    up.ingest(x, np.zeros(6))
    assert not up.should_fold
    up.ingest(x + 0.5, np.ones(6))
    assert up.buffered == 6 and not up.should_fold  # oldest evicted
    up.ingest(np.zeros((25, 784), np.float32), np.zeros(25))
    assert up.buffered == 10 and up.should_fold
    with pytest.raises(ValueError, match="mismatch"):
        up.ingest(x, np.zeros(2))
    hist = obs.REGISTRY.get("update_fold_ms")
    before = sum(v["count"] for _, v in hist.series())
    res = up.fold()
    assert res.generation == 1 and res.n_samples == 10 and res.shape_stable
    assert obs.gauge("model_generation").value() == 1.0
    assert sum(v["count"] for _, v in hist.series()) == before + 1
    recs = [json.loads(line) for line in
            (tmp_path / "ev.jsonl").read_text().splitlines()]
    folds = [r for r in recs if r["event"] == "model_fold"]
    assert len(folds) == 1 and folds[0]["n_samples"] == 10
    assert folds[0]["fold_ms"] == pytest.approx(res.fold_ms, abs=0.01)
    for bad in ({"fold_epochs": 0}, {"buffer_cap": 0}):
        with pytest.raises(ValueError):
            StreamingUpdater(tm, up.artifact, **bad)


def test_drifted_fold_recovers_accuracy(ds, full):
    _, tm = full
    dep = tm.deploy(target="packed")
    dx = apply_drift(ds["te_x"], 0.5)
    before = (n(dep.predict(dx)) == ds["te_y"]).mean()
    up = StreamingUpdater(tm, dep, fold_epochs=3)
    up.ingest(apply_drift(ds["tr_x"], 0.5), ds["tr_y"])
    res = up.fold()
    after = (n(up.artifact.predict(dx)) == ds["te_y"]).mean()
    assert res.shape_stable and 0.0 <= res.miss_rate <= 1.0
    assert after >= before + 0.05, (before, after)


# -- swap signatures ----------------------------------------------------------

@pytest.mark.parametrize("target,opts", [
    ("packed", {}), ("packed", {"mode": "unpack"}), ("unpacked", {}),
    ("imc", {}), ("multibit", {"cell_bits": 4}), ("hierarchical", {})])
def test_same_c_swap_keeps_the_signature(ds, full, partial, target, opts):
    _, tm = full
    dep = tm.deploy(target=target, **opts)
    sig = dep.swap_signature
    hash(sig)
    up = StreamingUpdater(tm, dep)
    up.ingest(apply_drift(ds["tr_x"][:200], 0.4), ds["tr_y"][:200])
    res = up.fold()
    assert res.shape_stable and up.artifact.swap_signature == sig
    assert up.artifact is not dep
    assert any(name == "n_dims" for name, *_ in sig)
    # Class growth changes it.
    _, tp = partial
    known = tp.am_cfg.classes
    gdep = tp.deploy(target=target, **opts)
    grown = tp.grow_classes(ds["tr_x"][ds["tr_y"] == known],
                            ds["tr_y"][ds["tr_y"] == known])
    assert gdep.refresh(grown).swap_signature != gdep.swap_signature


def test_preswap_inflight_batch_finishes_on_the_old_artifact(ds, partial):
    _, tm = partial
    known = tm.am_cfg.classes
    up = StreamingUpdater(tm, tm.deploy(target="packed"))
    x = ds["te_x"][:48]
    old = up.artifact
    want = n(old.predict(x))
    fut = old.predict(x)  # launched before the swap
    new = ds["tr_y"] == known
    up.ingest(ds["tr_x"][new], ds["tr_y"][new])
    up.fold()
    assert up.artifact is not old
    np.testing.assert_array_equal(n(fut), want)
    np.testing.assert_array_equal(n(old.predict(x)), want)


# -- the engine ---------------------------------------------------------------

def _engine(model, target="packed", **kw):
    up = StreamingUpdater(model, model.deploy(target=target))
    kw.setdefault("max_batch", 32)
    kw.setdefault("max_wait_ms", 5.0)
    return OnlineEngine(up, **kw)


def _record_generations(engine):
    """Wrap the updater's fold so each generation's model is kept:
    {generation: model}."""
    models = {0: engine.updater.model}
    fold = engine.updater.fold

    def recording():
        res = fold()
        if res is not None:
            models[res.generation] = engine.updater.model
        return res

    engine.updater.fold = recording
    return models


def test_empty_stream_and_oversized_request(full):
    _, tm = full
    eng = _engine(tm)
    rep = eng.serve([])
    assert rep["requests"] == 0 and rep["pad_overhead"] is None
    assert rep["lat_ms_p50"] is None and rep["recompiles_steady_state"] == 0
    big = OnlineRequest(rid=0, feats=np.zeros((33, 784), np.float32))
    with pytest.raises(ValueError, match="max_batch"):
        _engine(tm).serve([Arrival(t=0.0, request=big)])
    with pytest.raises(ValueError, match="depth"):
        _engine(tm, depth=0)


@pytest.mark.parametrize("target", ["packed", "hierarchical"])
def test_every_request_equals_the_plain_predict_of_its_generation(
        ds, partial, target):
    # Phase A on generation 0; a drifted same-C fold; phase B on
    # generation 1; a class append; phase C on generation 2. Each
    # response equals MemhdModel.predict of the generation that served it.
    _, tm = partial
    known = tm.am_cfg.classes
    eng = _engine(tm, target=target, depth=2)
    models = _record_generations(eng)
    tx, ty = ds["te_x"], ds["te_y"]
    a = poisson_arrivals(tx, n_requests=15, rate_qps=3000, max_size=6,
                         labels_pool=ty, classes=range(known), seed=8)
    t = a[-1].t + 1e-3
    keep = ds["tr_y"] < known
    f1 = feedback_burst(apply_drift(ds["tr_x"][keep], 0.4),
                        ds["tr_y"][keep], t=t, fold=True)
    b = poisson_arrivals(apply_drift(tx, 0.4), n_requests=15,
                         rate_qps=3000, max_size=6, labels_pool=ty,
                         classes=range(known), start=t, rid_base=1000,
                         seed=9)
    t = b[-1].t + 1e-3
    new = ds["tr_y"] == known
    f2 = feedback_burst(ds["tr_x"][new], ds["tr_y"][new], t=t, fold=True)
    c = poisson_arrivals(tx, n_requests=15, rate_qps=3000, max_size=6,
                         labels_pool=ty, start=t, rid_base=2000, seed=10)
    rep = eng.serve(merge_events(a, f1, b, f2, c))
    assert rep["requests"] == 45 and rep["model_generation"] == 2
    assert [g["shape_stable"] for g in rep["generations"]] == [True, False]
    assert rep["recompiles_steady_state"] == 0
    assert rep["rows_padded"] % eng.tile == 0
    for ev, gen in [(e, 0) for e in a] + [(e, 1) for e in b] + [
            (e, 2) for e in c]:
        r = ev.request
        assert eng.request_generation[r.rid] == gen
        np.testing.assert_array_equal(
            eng.responses[r.rid], n(models[gen].predict(r.feats)))
    json.dumps(rep)


def test_serve_online_cli_appends_a_class_with_zero_steady_rebuilds(
        tmp_path):
    from repro_torch.launch import serve_online
    mpath = tmp_path / "metrics.json"
    rep = serve_online.main(["--smoke", "--append-class", "--device", "cpu",
                             "--requests", "16", "--metrics-out",
                             str(mpath)])
    assert rep["model_generation"] == 2
    assert rep["recompiles_steady_state"] == 0
    assert [g["shape_stable"] for g in rep["generations"]] == [True, False]
    assert rep["classes"] == 10 and rep["device"] == "cpu"
    assert set(rep["phases"]) == {"A", "B", "C"}
    snap = json.loads(mpath.read_text())
    assert snap["model_generation"]["values"][""] == 2.0
    # --devices is ported (tests/test_torch_sharded.py); --record-dir is
    # not.
    with pytest.raises(NotImplementedError, match="item 16"):
        serve_online.main(["--smoke", "--device", "cpu", "--record-dir",
                           str(tmp_path)])
