"""The slice end to end on the CPU: the port against the JAX package.

A small JAX model (f = 64, D = C = 128, synthetic MNIST with 30 rows per
class) is initialized by clustering; its projection and initial AM cross
to the port through ``convert.model_from_numpy``, and both sides then run
``fit(init_method="keep")`` -> ``deploy(target="packed")`` -> predict /
predict_features / score / serve_batches.

Dyadic conditions make every step exact in any summation order: features
rounded to multiples of 2^-8, the initial float AM rounded the same way,
lr = 2^-4, normalize="none" and D*C = 2^14. Under them the binary AMs and
every served class must be bit-equal — for the batched fit, the fit
through the ``qail_update`` route, the sequential fit, a fit resumed
from the reference's checkpoint, and every deployment target and mode.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import EncoderConfig, MemhdConfig, MemhdModel  # noqa: E402
from repro.core import am as jam  # noqa: E402
from repro.data import load_dataset as jax_load_dataset  # noqa: E402
from repro.launch import serve_memhd as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve_memhd as tserve  # noqa: E402

F = 64


def _dyadic(x):
    return (np.round(np.asarray(x)[:, :F] * 256) / 256).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    ds = jax_load_dataset("mnist", train_per_class=30, test_per_class=10)
    tr_x, te_x = _dyadic(ds.train_x), _dyadic(ds.test_x)
    tr_y, te_y = np.asarray(ds.train_y), np.asarray(ds.test_y)
    enc = EncoderConfig(kind="projection", features=F, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=2,
                      lr=0.0625, normalize="none", kmeans_iters=5,
                      batch_size=64)
    jm = MemhdModel.create(jax.random.key(0), enc, amc)
    jm, _ = jm.initialize_am(jax.random.key(1), tr_x, tr_y)
    fp0 = np.round(np.asarray(jm.am_state["fp"]) * 256) / 256
    state = jam.make_am_state(jax.numpy.asarray(fp0, jax.numpy.float32),
                              jm.am_state["centroid_class"], amc.threshold)
    jm = dataclasses.replace(jm, am_state=state)
    tm = convert.model_from_numpy(
        {"projection": np.asarray(jm.enc_params["projection"])},
        {k: np.asarray(v) for k, v in jm.am_state.items()},
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    jm0, tm0 = jm, tm
    jm, jhist = jm.fit(jax.random.key(2), tr_x, tr_y, init_method="keep")
    tm, thist = tm.fit(2, tr_x, tr_y, init_method="keep")
    return dict(jm=jm, tm=tm, jdep=jm.deploy(target="packed"),
                tdep=tm.deploy(target="packed"), te_x=te_x, te_y=te_y,
                jhist=jhist, thist=thist, jm0=jm0, tm0=tm0, tr_x=tr_x,
                tr_y=tr_y)


def test_weights_cross_unchanged():
    enc = EncoderConfig(features=4, dim=8)
    amc = MemhdConfig(dim=8, columns=3, classes=3)
    rng = np.random.default_rng(0)
    proj = rng.choice([-1.0, 1.0], (4, 8)).astype(np.float32)
    fp = rng.normal(size=(3, 8)).astype(np.float32)
    m = convert.model_from_numpy(
        {"projection": proj},
        {"fp": fp, "binary": np.sign(fp), "centroid_class": [0, 1, 2]},
        dataclasses.asdict(enc), dataclasses.asdict(amc), device="cpu")
    np.testing.assert_array_equal(m.enc_params["projection"].numpy(), proj)
    np.testing.assert_array_equal(m.am_state["fp"].numpy(), fp)
    assert m.am_state["centroid_class"].dtype == torch.int32
    assert dataclasses.asdict(m.am_cfg) == dataclasses.asdict(amc)


def test_fit_keep_gives_bit_equal_am(pair):
    np.testing.assert_array_equal(pair["tm"].am_state["binary"].numpy(),
                                  np.asarray(pair["jm"].am_state["binary"]))
    np.testing.assert_array_equal(pair["tm"].am_state["fp"].numpy(),
                                  np.asarray(pair["jm"].am_state["fp"]))
    assert ([r["train_miss"] for r in pair["thist"]["curve"]]
            == [r["train_miss"] for r in pair["jhist"]["curve"]])


def test_deployed_predictions_and_accounting_match(pair):
    jdep, tdep, x = pair["jdep"], pair["tdep"], pair["te_x"]
    want = np.asarray(jdep.predict(x))
    np.testing.assert_array_equal(tdep.predict(x).numpy(), want)
    np.testing.assert_array_equal(tdep.predict_features(x).numpy(), want)
    np.testing.assert_array_equal(np.asarray(jdep.predict_features(x)), want)
    np.testing.assert_array_equal(pair["tm"].predict(x).numpy(),
                                  np.asarray(pair["jm"].predict(x)))
    assert tdep.score(x, pair["te_y"]) == jdep.score(x, pair["te_y"])
    assert tdep.resident_am_bytes == jdep.resident_am_bytes
    assert tdep.am_memory_ratio == jdep.am_memory_ratio
    np.testing.assert_array_equal(tdep.am_packed_t.numpy(),
                                  np.asarray(jdep.am_packed_t))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_serve_batches_matches_reference(pair, fused, depth):
    from repro_torch.kernels import ops
    ops.reset_dispatch()
    reqs = tserve.synthetic_requests(pair["te_x"], 13, 9, seed=3)
    jreqs = jserve.synthetic_requests(pair["te_x"], 13, 9, seed=3)
    got, tstats = tserve.serve_batches(pair["tdep"], reqs, max_batch=24,
                                       fused=fused, depth=depth)
    want, jstats = jserve.serve_batches(pair["jdep"], jreqs, max_batch=24,
                                        fused=fused, depth=depth)
    assert got.keys() == want.keys()
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    for k in ("depth", "batches", "rows_real", "rows_padded",
              "pad_overhead"):
        assert tstats[k] == jstats[k]
    if depth == 1:
        assert tstats["queue_ms_p99"] == 0.0
    trep = tserve.build_report(pair["tdep"], reqs, tstats, 1.0, fused=fused)
    jrep = jserve.build_report(pair["jdep"], jreqs, jstats, 1.0,
                               fused=fused)
    assert trep.keys() == jrep.keys()
    # The metrics section has the reference's keys; the port's
    # ``compiles_total`` counts kernel builds and graph captures.
    assert trep["metrics"].keys() == jrep["metrics"].keys()
    tmetrics = tserve.metrics_summary(recompiles_steady_state=0)
    assert tmetrics.keys() == jserve.metrics_summary(
        recompiles_steady_state=0).keys()
    for k in ("backend", "packed", "mode", "pipeline", "geometry", "rows",
              "resident_am_bytes", "am_memory_ratio"):
        assert trep[k] == jrep[k]
    search = "predict_from_features" if fused else "am_search_packed"
    assert set(trep["metrics"]["dispatch_tiers"][search]) == {"torch-ref"}


@pytest.mark.parametrize("fit_kw", [{"use_kernel": True},
                                    {"mode": "sequential"}])
def test_fit_routes_give_bit_equal_am(pair, fit_kw):
    # The fit through the qail_update route (the Pallas kernel in
    # interpret mode on the JAX side) and the sample-by-sample fit.
    jm, jhist = pair["jm0"].fit(jax.random.key(2), pair["tr_x"],
                                pair["tr_y"], init_method="keep", **fit_kw)
    tm, thist = pair["tm0"].fit(2, pair["tr_x"], pair["tr_y"],
                                init_method="keep", **fit_kw)
    for k in ("fp", "binary"):
        np.testing.assert_array_equal(tm.am_state[k].numpy(),
                                      np.asarray(jm.am_state[k]))
    assert np.array_equal([r["train_miss"] for r in thist["curve"]],
                          [r["train_miss"] for r in jhist["curve"]],
                          equal_nan=True)
    if "use_kernel" in fit_kw:  # the same AM as the plain batched fit
        np.testing.assert_array_equal(tm.am_state["fp"].numpy(),
                                      pair["tm"].am_state["fp"].numpy())


def test_port_resumes_a_reference_checkpoint(pair, tmp_path):
    # The reference fits one epoch and checkpoints it; the port's fit
    # resumes from the reference's files (same leaf keys) and finishes
    # epoch 2 on the AM of the reference's own uninterrupted fit.
    from repro.checkpoint import CheckpointConfig as JConfig
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    d = str(tmp_path / "run")
    pair["jm0"].fit(jax.random.key(2), pair["tr_x"], pair["tr_y"],
                    init_method="keep", epochs=1, ckpt=JManager(JConfig(d)))
    tm, thist = pair["tm0"].fit(2, pair["tr_x"], pair["tr_y"],
                                init_method="keep",
                                ckpt=CheckpointManager(CheckpointConfig(d)))
    for k in ("fp", "binary"):
        np.testing.assert_array_equal(tm.am_state[k].numpy(),
                                      np.asarray(pair["jm"].am_state[k]))
    assert thist["curve"] == pair["jhist"]["curve"]


@pytest.mark.parametrize("target,mode", [("unpacked", "popcount"),
                                         ("packed", "unpack")])
def test_unpacked_target_and_unpack_mode_match(pair, target, mode):
    jdep = pair["jm"].deploy(target=target, mode=mode)
    tdep = pair["tm"].deploy(target=target, mode=mode)
    x = pair["te_x"]
    want = np.asarray(jdep.predict(x))
    np.testing.assert_array_equal(tdep.predict(x).numpy(), want)
    np.testing.assert_array_equal(tdep.predict_features(x).numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(pair["jdep"].predict(x)))
    assert tdep.score(x, pair["te_y"]) == jdep.score(x, pair["te_y"])
    for k in ("backend", "serving_mode", "resident_bytes", "packed",
              "fusable", "am_memory_ratio"):
        assert getattr(tdep, k) == getattr(jdep, k), k
    if target == "unpacked":
        np.testing.assert_array_equal(tdep.am_binary.numpy(),
                                      np.asarray(jdep.am_binary))
        assert tdep.am_packed_t is None and tdep.resident_bytes == 128 * 128 * 4
        assert pair["tm"].deploy(packed=False).backend == "unpacked"
    # refresh re-freezes from a model, keeping target and mode.
    again = tdep.refresh(pair["tm"])
    assert (again.backend, again.serving_mode) == (tdep.backend,
                                                   tdep.serving_mode)
    np.testing.assert_array_equal(again.predict(x).numpy(), want)
    reqs = tserve.synthetic_requests(x, 13, 9, seed=3)
    got, _ = tserve.serve_batches(tdep, reqs, max_batch=24, depth=2)
    wresp, _ = jserve.serve_batches(
        jdep, jserve.synthetic_requests(x, 13, 9, seed=3), max_batch=24,
        depth=2)
    for rid in wresp:
        np.testing.assert_array_equal(got[rid], np.asarray(wresp[rid]))


@pytest.mark.parametrize("argv", [["--target", "unpacked"], ["--unpacked"],
                                  ["--mode", "unpack"]])
def test_serving_cli_targets_and_modes(argv):
    rep = tserve.main(["--smoke", "--device", "cpu", "--requests", "6",
                       "--max-size", "5", *argv])
    assert rep["backend"] == ("packed" if "--mode" in argv else "unpacked")
    assert rep["mode"] == ("unpack" if "--mode" in argv else "float")
    assert rep["requests"] == 6


def test_empty_stream_reports_nulls(pair):
    _, stats = tserve.serve_batches(pair["tdep"], [])
    assert stats["batches"] == 0 and stats["lat_ms_p50"] is None
    assert stats["pad_overhead"] is None


def test_unknown_targets_raise_and_every_ported_target_serves(pair):
    # Sharded serving is a wrapper (deploy.ShardedArtifact, held against
    # the reference in tests/test_torch_sharded.py), not a deploy target;
    # the imc, multibit and hierarchical targets and top-k serving are
    # ported (tests/test_torch_imcsim.py, tests/test_torch_hierarchical.py).
    with pytest.raises(ValueError, match="unknown deploy target"):
        pair["tm"].deploy(target="sharded")
    with pytest.raises(ValueError, match="mode"):
        pair["tm"].deploy(target="packed", mode="xor")
    rep = tserve.main(["--smoke", "--device", "cpu", "--devices", "2",
                       "--requests", "4"])
    assert (rep["devices"], rep["backend"]) == (2, "packed")
    rep = tserve.main(["--smoke", "--device", "cpu", "--requests", "4",
                       "--target", "hierarchical", "--topk", "4"])
    assert (rep["backend"], rep["topk"]) == ("hierarchical", 4)
    with pytest.raises(SystemExit):  # --topk needs the hierarchical target
        tserve.main(["--smoke", "--device", "cpu", "--topk", "4"])
    hier = pair["tm"].deploy(target="hierarchical")
    np.testing.assert_array_equal(hier.predict(pair["te_x"]).numpy(),
                                  pair["tdep"].predict(pair["te_x"]).numpy())
    assert pair["tm"].deploy(target="imc").backend == "imc"
    assert pair["tm"].deploy(target="multibit",
                             cell_bits=4).backend == "multibit"


@pytest.mark.parametrize("target,opts", [("imc", {}),
                                         ("multibit", {"cell_bits": 4}),
                                         ("multibit", {"cell_bits": 2})])
def test_device_fidelity_targets_serve_like_the_reference(pair, target,
                                                          opts):
    # The fit-keep pair's AMs are bit-equal, so the ideal imc artifact
    # and the multibit artifacts (quantized from the float shadow) serve
    # the reference's classes on every request.
    tdep = pair["tm"].deploy(target=target, **opts)
    jdep = pair["jm"].deploy(target=target, **opts)
    x = pair["te_x"]
    np.testing.assert_array_equal(tdep.predict(x).numpy(),
                                  np.asarray(jdep.predict(x)))
    reqs = tserve.synthetic_requests(x, 13, 9, seed=5)
    got, _ = tserve.serve_batches(tdep, reqs, max_batch=24, depth=2)
    want, _ = jserve.serve_batches(
        jdep, jserve.synthetic_requests(x, 13, 9, seed=5), max_batch=24,
        depth=2)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))
    rep = tserve.build_report(tdep, reqs, {}, 1.0)
    assert (rep["backend"], rep["mode"], rep["cycles"]) == (
        jdep.backend, jdep.serving_mode, jdep.cycles)
    assert rep["resident_am_bytes"] == jdep.resident_am_bytes

