"""The device-fidelity slice of the port against the JAX package, on the CPU.

The imc and multibit kernels' plain versions against the reference's
Pallas kernels (interpret mode) and oracles; the device models, the imc
and multibit artifacts, noise-aware QAIL and multi-bit QAT against the
reference; the robustness and serving CLIs.

Random fields: ``jax.random`` streams cannot be reproduced in torch, so
where the port must equal the reference it is handed the reference's
fields. ``jax_sampler`` maps each key of the port's key tree
(``repro_torch.imcsim.device``) onto the reference's ``jax.random`` key
(splits and fold_ins) and draws the field there.

Exact where the arithmetic is exact: bipolar and integer-code operands,
dyadic noise and offsets, power-of-two ADC steps, dyadic features and lr.
Where float rounding enters (a float-noise AM, float features), the
tolerance is stated beside the test.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EncoderConfig as JEncoderConfig  # noqa: E402
from repro.core import ImcArrayConfig as JArr  # noqa: E402
from repro.core import ImcSimConfig as JSim  # noqa: E402
from repro.core import MemhdConfig as JMemhdConfig  # noqa: E402
from repro.core import MemhdModel as JModel  # noqa: E402
from repro.core import am as jam  # noqa: E402
from repro.core import imc as jimc  # noqa: E402
from repro.data import load_dataset as jax_load_dataset  # noqa: E402
from repro.imcsim import device as jdevice  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.binary_mvm import binary_mvm as jax_binary_mvm  # noqa: E402
from repro.kernels.pack_bits import unpack_bits as jax_unpack_bits  # noqa: E402
from repro.launch import serve_memhd as jserve  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import imcsim  # noqa: E402
from repro_torch.core import ImcArrayConfig, ImcSimConfig, am, imc  # noqa: E402
from repro_torch.core import qail, types  # noqa: E402
from repro_torch.data import load_dataset  # noqa: E402
from repro_torch.imcsim import device  # noqa: E402
from repro_torch.kernels import am_search_imc as asi  # noqa: E402
from repro_torch.kernels import am_search_multibit as asm  # noqa: E402
from repro_torch.kernels import binary_mvm, ops, pack_bits, ref  # noqa: E402
from repro_torch.launch import robustness_report as trobust  # noqa: E402
from repro_torch.launch import serve_memhd as tserve  # noqa: E402

ARRAYS = [(128, 128), (64, 128), (256, 128)]
ADC_BITS = [16, 8, 6, 4, 2]


def rng_for(*key):
    return np.random.default_rng([2718, *key])


def bipolar(rng, shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def jsim(sim: ImcSimConfig) -> JSim:
    """The reference's ImcSimConfig with the same fields."""
    d = dataclasses.asdict(sim)
    return JSim(**dict(d, arr=JArr(**d["arr"])))


def jax_key(key):
    """The reference's jax.random key for a key of the port's key tree:
    (s, i) = split(key(s))[i]; (s, 0, i) = split(split(key(s))[0])[i];
    the fresh-mode (s, e, b) = fold_in(fold_in(key(s), e), b) (e >= 1),
    and (s, e, b, i) its split i."""
    s, *rest = key
    k = jax.random.key(s)
    if len(rest) == 1:
        return jax.random.split(k)[rest[0]]
    if rest[0] == 0:
        return jax.random.split(jax.random.split(k)[0])[rest[1]]
    k = jax.random.fold_in(jax.random.fold_in(k, rest[0]), rest[1])
    return k if len(rest) == 2 else jax.random.split(k)[rest[2]]


def jax_sampler(key, shape, kind, dev):
    """A port sampler drawing the reference's field for ``key``."""
    k = jax_key(key)
    draw = jax.random.uniform if kind == "uniform" else jax.random.normal
    return torch.from_numpy(np.array(draw(k, shape))).to(dev)


# -- the ADC and the imc search -----------------------------------------------

def test_adc_quantize_ties_to_even_and_clip():
    # clip 4, 2 bits: step 2. Half steps (1, 3, -1, -3) round to the even
    # code, values at and beyond +-clip land on +-clip; a non-power-of-
    # two clip exercises the true division.
    x = np.array([1.0, 3.0, -1.0, -3.0, 5.0, 4.0, -4.0, -7.5, 0.999, 2.5,
                  -0.0, 0.5], np.float32)
    for bits, clip in ((2, 4.0), (3, 4.0), (6, 100.0), (4, 3.3)):
        got = n(ref.adc_quantize(t(x), bits, clip))
        want = np.asarray(jref.adc_quantize(jnp.asarray(x), bits, clip))
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        n(ref.adc_quantize(t(x[:7]), 2, 4.0)),
        np.array([0, 4, 0, -4, 4, 4, -4], np.float32))


def imc_operands(rng, d, c, *, dup=False, noise=None, offsets=False,
                 arr=(128, 128)):
    am_ = bipolar(rng, (c, d))
    if dup:  # duplicated columns: every query's maximum is tied
        am_ = am_[np.arange(c) % max(1, c // 3)]
    if noise == "dyadic":  # 0.5 * z on a 2^-6 grid: exact partial sums
        am_ = am_ + 0.5 * np.round(rng.normal(size=(c, d)) * 64) / 64
    elif noise == "float":
        am_ = am_ + 0.5 * rng.normal(size=(c, d))
    gd, gc = -(-d // arr[0]), -(-c // arr[1])
    off = (np.round(rng.normal(0, 2, (gd, gc)) * 16) / 16).astype(
        np.float32) if offsets else None
    return am_.astype(np.float32), off


def both_imc(q, am_, off, arr, bits):
    sim = ImcSimConfig(arr=ImcArrayConfig(rows=arr[0], cols=arr[1]),
                       adc_bits=bits)
    got = ops.am_search_imc(t(q), t(am_), sim=sim,
                            offsets=None if off is None else t(off))
    want = jops.am_search_imc(jnp.asarray(q), jnp.asarray(am_),
                              sim=jsim(sim),
                              offsets=None if off is None
                              else jnp.asarray(off))
    return got, want


@pytest.mark.parametrize("arr", ARRAYS)
@pytest.mark.parametrize("bits", ADC_BITS)
@pytest.mark.parametrize("case", ["pm1", "pm1_offsets", "dup", "dyadic"])
def test_am_search_imc_against_pallas(arr, bits, case):
    rng = rng_for(arr[0], bits, len(case))
    b, d, c = 9, 256, 200
    am_, off = imc_operands(rng, d, c, dup=case == "dup",
                            noise="dyadic" if case == "dyadic" else None,
                            offsets=case in ("pm1_offsets", "dyadic"),
                            arr=arr)
    q = bipolar(rng, (b, d))
    (idx, sim), (j_idx, j_sim) = both_imc(q, am_, off, arr, bits)
    np.testing.assert_array_equal(n(idx), np.asarray(j_idx))
    np.testing.assert_array_equal(n(sim), np.asarray(j_sim))
    assert idx.dtype == torch.int32 and sim.dtype == torch.float32
    if case == "dup" and bits >= 8:  # exact sims: the lower index wins
        assert (n(idx) < c // 3).all()
    # The wrapper takes the same plain path on the CPU.
    w_idx, w_sim = asi.am_search_imc(
        t(q), t(am_).T, None if off is None else t(off), tile_rows=arr[0],
        tile_cols=arr[1], adc_bits=bits, adc_clip=float(arr[0]))
    assert torch.equal(w_idx, idx) and torch.equal(w_sim, sim)


def test_ideal_imc_equals_exact_search():
    # >= 8-bit ADC on 128-row arrays, no perturbation: the digital search.
    rng = rng_for(1)
    q, am_ = bipolar(rng, (17, 256)), bipolar(rng, (130, 256))
    am_ = am_[np.arange(130) % 40]
    for bits in (16, 8):
        sim = ImcSimConfig(adc_bits=bits)
        got = ops.am_search_imc(t(q), t(am_), sim=sim)
        want = ops.am_search(t(q), t(am_))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("arr", ARRAYS)
@pytest.mark.parametrize("bits", [16, 6, 3])
def test_am_search_imc_float_noise_within_tolerance(arr, bits):
    """Float noise: the torch and XLA partial sums may round differently.
    Stated tolerance: a tile output may differ by one ADC step only where
    its pre-ADC partial sum lies within 2^-20 * sum|terms| of a rounding
    boundary; so a query may differ only if one of its tiles is that
    close, and its similarity by at most one step per row tile."""
    rng = rng_for(2, arr[0], bits)
    b, d, c = 16, 256, 200
    am_, off = imc_operands(rng, d, c, noise="float", offsets=True, arr=arr)
    q = bipolar(rng, (b, d))
    (idx, sim), (j_idx, j_sim) = both_imc(q, am_, off, arr, bits)
    rows, cols = arr
    clip, step = float(rows), 2.0 * rows / 2 ** bits
    gd = -(-d // rows)
    qr = np.pad(q.astype(np.float64), ((0, 0), (0, gd * rows - d))
                ).reshape(b, gd, rows)
    ar = np.pad(am_.astype(np.float64), ((0, 0), (0, gd * rows - d))
                ).reshape(c, gd, rows)
    part = np.einsum("bgr,cgr->bgc", qr, ar) + np.repeat(
        off.astype(np.float64), cols, axis=1)[None, :, :c]
    mag = np.einsum("bgr,cgr->bgc", np.abs(qr), np.abs(ar))
    part = np.clip(part, -clip, clip)
    dist = np.abs(part / step - np.floor(part / step) - 0.5) * step
    near = (dist <= 2.0 ** -20 * mag).any(axis=(1, 2))
    same = (n(idx) == np.asarray(j_idx)) & (n(sim) == np.asarray(j_sim))
    assert (same | near).all()
    assert (np.abs(n(sim) - np.asarray(j_sim)) <= gd * step).all()


# -- the multibit search --------------------------------------------------------

@pytest.mark.parametrize("cell_bits", range(2, 9))
@pytest.mark.parametrize("arr", [(128, 128), (64, 128)])
def test_am_search_multibit_against_pallas(cell_bits, arr):
    rng = rng_for(3, cell_bits, arr[0])
    b, d, c = 7, 250, 130  # D not a byte multiple: tail cells
    qmax = 2 ** (cell_bits - 1) - 1
    codes = rng.integers(-qmax, qmax + 1, (c, d)).astype(np.int32)
    planes = am.pack_am_planes(t(codes), cell_bits)
    np.testing.assert_array_equal(
        n(planes), np.asarray(jam.pack_am_planes(jnp.asarray(codes),
                                                 cell_bits)))
    q = bipolar(rng, (b, d))
    gd, gc = -(-d // arr[0]), -(-c // arr[1])
    off = (np.round(rng.normal(0, 4, (gd, gc)) * 16) / 16).astype(np.float32)
    for adc_bits, o in ((16, None), (4, off)):  # exact, then a coarse ADC
        sim = ImcSimConfig(arr=ImcArrayConfig(rows=arr[0], cols=arr[1]),
                           adc_bits=adc_bits)
        got = ops.am_search_multibit(t(q), planes, sim=sim,
                                     offsets=None if o is None else t(o))
        want = jops.am_search_multibit(
            jnp.asarray(q), jnp.asarray(n(planes)), sim=jsim(sim),
            offsets=None if o is None else jnp.asarray(o))
        np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
        np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    # A 16-bit ADC reproduces the exact code-domain search.
    idx, s = ref.am_search_multibit(t(q), planes, cell_bits=cell_bits)
    exact = t(q) @ t(codes.astype(np.float32)).T
    assert torch.equal(s, exact.max(dim=1).values)
    # The dequantizing scale multiplies the similarity only.
    i2, s2 = ops.am_search_multibit(t(q), planes, scale=0.5)
    assert torch.equal(i2, idx) and torch.equal(s2, s * 0.5)


def test_pack_planes_round_trip_and_layout():
    rng = rng_for(4)
    u = rng.integers(0, 15, (5, 21)).astype(np.int32)
    planes = ref.pack_planes(t(u), 4)
    assert planes.shape == (4, 3, 5) and planes.dtype == torch.uint8
    np.testing.assert_array_equal(
        n(planes), np.asarray(jref.pack_planes(jnp.asarray(u), 4)))
    back = n(ref.unpack_planes(planes))
    np.testing.assert_array_equal(back[:21], u.T)
    assert not back[21:].any()  # D-tail cells unpack to code 0
    # Plane p, byte j, column c: bit k is bit p of u[c, 8j + k].
    assert n(planes)[2, 1, 3] == sum(((u[3, 8 + k] >> 2) & 1) << k
                                     for k in range(8))
    np.testing.assert_array_equal(
        back, np.asarray(jref.unpack_planes(jnp.asarray(n(planes)))))


def mse_gap(fp, cell_bits):
    """Relative gap between the best and the runner-up grid MSE of
    quantize_am, in float64."""
    qmax = 2 ** (cell_bits - 1) - 1
    amax = np.abs(fp).max()
    fracs = np.array((1.0, 0.7, 0.5, 0.35, 0.25, 0.15, 0.1, 0.05))
    mse = []
    for s in fracs * amax / qmax:
        cand = np.clip(np.round(fp / s), -qmax, qmax)
        mse.append(np.mean((cand * s - fp) ** 2))
    a, b = sorted(mse)[:2]
    return (b - a) / a


@pytest.mark.parametrize("cell_bits", range(2, 9))
def test_quantize_am_against_reference(cell_bits):
    """Bit-exact on AMs whose winning grid scale beats the runner-up's
    MSE by a relative 1e-5 or more (asserted). Closer than that, the two
    frameworks' mean reductions may round the MSEs apart and pick the
    other scale."""
    fp = (rng_for(5, cell_bits).standard_t(3, (64, 200)) * 0.3).astype(
        np.float32)
    assert mse_gap(fp.astype(np.float64), cell_bits) >= 1e-5
    codes, scale = am.quantize_am(t(fp), cell_bits)
    j_codes, j_scale = jam.quantize_am(jnp.asarray(fp), cell_bits)
    np.testing.assert_array_equal(n(codes), np.asarray(j_codes))
    assert float(scale) == float(j_scale)
    assert codes.dtype == torch.int32 and scale.dtype == torch.float32
    np.testing.assert_array_equal(
        n(am.dequantize_am(codes, scale)),
        np.asarray(jam.dequantize_am(j_codes, j_scale)))
    assert am.multibit_am_bytes(200, 64, cell_bits) == \
        jam.multibit_am_bytes(200, 64, cell_bits)
    with pytest.raises(ValueError, match="outside"):
        am.quantize_am(t(fp), 9)


# -- binary_mvm and unpack_bits -------------------------------------------------

@pytest.mark.parametrize("b,k,n_", [(1, 16, 128), (8, 256, 128),
                                    (3, 100, 257), (2, 64, 26)])
def test_binary_mvm_against_pallas(b, k, n_):
    rng = rng_for(6, b, k, n_)
    w = bipolar(rng, (k, n_))
    xd = (np.round(rng.random((b, k)) * 256) / 256).astype(np.float32)
    want = np.asarray(jax_binary_mvm(jnp.asarray(xd), jnp.asarray(w)))
    np.testing.assert_array_equal(n(binary_mvm.binary_mvm(t(xd), t(w))),
                                  want)  # dyadic: exact in any order
    np.testing.assert_array_equal(n(ops.encode_mvm(t(xd), t(w))), want)
    # Float features: |error| <= 2^-20 * sum|x*w| (summation order).
    xf = rng.random((b, k), dtype=np.float32)
    got = n(ops.encode_mvm(t(xf), t(w)))
    want = np.asarray(jax_binary_mvm(jnp.asarray(xf), jnp.asarray(w)))
    assert (np.abs(got - want) <= 2.0 ** -20 * (np.abs(xf) @ np.abs(w))
            ).all()


@pytest.mark.parametrize("r,cb", [(3, 1), (5, 16), (2, 33)])
def test_unpack_bits_against_pallas(r, cb):
    p = rng_for(7, r, cb).integers(0, 256, (r, cb), dtype=np.uint8)
    got = n(pack_bits.unpack_bits(t(p)))
    np.testing.assert_array_equal(got, np.asarray(jax_unpack_bits(
        jnp.asarray(p))))
    np.testing.assert_array_equal(n(ops.unpack_bits(t(p))), got)
    # The tail bits of the last byte unpack too (bit 1 -> +1).
    assert (got[:, -1] == np.where(p[:, -1] >> 7, 1.0, -1.0)).all()
    with pytest.raises(ValueError, match="multiple of 8"):
        pack_bits.unpack_bits(t(p), n_cols=cb * 8 - 3)


@pytest.mark.parametrize("d,c,rows,cols", [(128, 128, 128, 128),
                                           (1024, 1024, 128, 128),
                                           (200, 70, 64, 32),
                                           (256, 128, 256, 128)])
def test_kernel_grids_equal_the_cycle_model(d, c, rows, cols):
    arr = ImcArrayConfig(rows=rows, cols=cols)
    cycles = imc.map_memhd(d, c, arr).cycles
    assert cycles == jimc.map_memhd(d, c, JArr(rows=rows, cols=cols)).cycles
    assert asi.imc_cycles_for((d, c), rows, cols) == cycles
    assert asm.imc_cycles_for((4, -(-d // 8), c), rows, cols) == cycles
    assert binary_mvm.imc_cycles_for((1, d), (d, c)) == \
        imc.map_basic(d, c, ImcArrayConfig()).cycles
    assert imc.sim_grid(d, c, arr) == device.tile_grid(d, c, ImcSimConfig(
        arr=arr)) == jdevice.tile_grid(d, c, JSim(arr=JArr(rows=rows,
                                                           cols=cols)))


# -- the device models ----------------------------------------------------------

def test_device_models_apply_the_crossed_fields():
    am_ = bipolar(rng_for(8), (64, 256))
    sim = ImcSimConfig(noise_sigma=0.5, fault_p0=0.05, fault_p1=0.05,
                       drift_sigma=1.0, seed=9,
                       arr=ImcArrayConfig(rows=64, cols=32))
    got, off = device.perturb_am(t(am_), sim, sampler=jax_sampler)
    want, j_off = jdevice.perturb_am(jax.random.key(9), jnp.asarray(am_),
                                     jsim(sim))
    np.testing.assert_array_equal(n(got), np.asarray(want))
    np.testing.assert_array_equal(n(off), np.asarray(j_off))
    assert off.shape == device.tile_grid(256, 64, sim) == (4, 2)
    # The port's own draws: seeded, faults at the right rate.
    a1, o1 = device.perturb_am(t(am_), sim)
    a2, o2 = device.perturb_am(t(am_), sim)
    assert torch.equal(a1, a2) and torch.equal(o1, o2)
    f = device.stuck_at_faults(t(am_), device.draw((1, 2), am_.shape,
                                                   "uniform", "cpu"),
                               0.1, 0.1)
    assert set(np.unique(n(f))) <= {-1.0, 1.0}
    assert 0.05 < (n(f) != am_).mean() < 0.15
    ideal, none = device.perturb_am(t(am_), ImcSimConfig())
    assert torch.equal(ideal, t(am_)) and none is None


def test_fixed_mode_trains_on_the_draws_deploy_burns():
    """Chip in the loop: every fixed-mode training batch perturbs with
    exactly the fields deploy_imc burns into the device instance."""
    log = []

    def recording(key, shape, kind, dev):
        log.append((tuple(key), tuple(shape), kind))
        return device.draw(key, shape, kind, dev)

    ds = load_dataset("mnist", train_per_class=10, test_per_class=2,
                      device="cpu")
    enc = types.EncoderConfig(features=784, dim=64)
    amc = types.MemhdConfig(dim=64, columns=32, classes=10, epochs=1,
                            kmeans_iters=2, batch_size=40)
    from repro_torch.core import MemhdModel
    m, _ = MemhdModel.create(0, enc, amc, device="cpu").fit(
        1, ds.train_x, ds.train_y)
    sim = ImcSimConfig(noise_sigma=0.5, fault_p0=0.02, seed=5)
    m.fit(2, ds.train_x, ds.train_y, init_method="keep", epochs=2,
          noise_sim=sim, noise_sampler=recording)
    trained = set(log)
    log.clear()
    m.deploy(target="imc", sim=sim, sampler=recording)
    assert trained == set(log)
    assert device.device_instance_key(sim) == (5, 0)
    assert {k[:2] for k, _, _ in log} == {device.device_instance_key(sim)}
    # The reference's device_instance_key is the cell split of the same
    # seed, which jax_key maps the port's key onto.
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jdevice.device_instance_key(
            jsim(sim)))),
        np.asarray(jax.random.key_data(jax_key((5, 0)))))


# -- artifacts and training against the reference -------------------------------

F = 64


def _dyadic(x):
    return (np.round(np.asarray(x)[:, :F] * 256) / 256).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    """A JAX model initialized by clustering and its port, under dyadic
    conditions (features and the initial AM on a 2^-8 grid, lr = 2^-4,
    normalize none, D*C = 2^14), as in tests/test_torch_pipeline.py."""
    ds = jax_load_dataset("mnist", train_per_class=30, test_per_class=10)
    tr_x, te_x = _dyadic(ds.train_x), _dyadic(ds.test_x)
    tr_y, te_y = np.asarray(ds.train_y), np.asarray(ds.test_y)
    enc = JEncoderConfig(kind="projection", features=F, dim=128)
    amc = JMemhdConfig(dim=128, columns=128, classes=10, epochs=2,
                       lr=0.0625, normalize="none", kmeans_iters=5,
                       batch_size=100)
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


def assert_same_am(tm, jm):
    for k in ("fp", "binary"):
        np.testing.assert_array_equal(n(tm.am_state[k]),
                                      np.asarray(jm.am_state[k]))


NOISY = [ImcSimConfig(noise_sigma=0.5, fault_p0=0.03, fault_p1=0.02,
                      seed=4),
         ImcSimConfig(fault_p0=0.05, fault_p1=0.05, seed=11)]


@pytest.mark.parametrize("mode", ["fixed", "fresh"])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("si", range(len(NOISY)))
def test_noise_aware_fit_against_reference(pair, mode, use_kernel, si):
    """Noise-aware QAIL, 2 epochs x 3 batches, on the reference's
    fields: the float shadow and the binary AM bit-equal."""
    sim = NOISY[si]
    jm, _ = pair["jm"].fit(jax.random.key(2), pair["tr_x"], pair["tr_y"],
                           init_method="keep", noise_sim=jsim(sim),
                           noise_mode=mode, use_kernel=use_kernel)
    tm, thist = pair["tm"].fit(2, pair["tr_x"], pair["tr_y"],
                               init_method="keep", noise_sim=sim,
                               noise_mode=mode, use_kernel=use_kernel,
                               noise_sampler=jax_sampler)
    assert_same_am(tm, jm)
    assert thist["curve"][-1]["train_miss"] > 0  # the hook is not a no-op


@pytest.mark.parametrize("use_kernel", [False, True])
def test_multibit_qat_fit_against_reference(pair, use_kernel):
    """Multi-bit QAT against the reference run with jit disabled: under
    jit, XLA turns quantize_am's division by the constant Qmax into a
    product with its float32 reciprocal, so the jitted reference's scale
    can differ by an ulp from its own eager quantize_am (which its
    multibit deploy runs). The port divides, as the reference's code
    reads."""
    with jax.disable_jit():
        jm, _ = pair["jm"].fit(jax.random.key(2), pair["tr_x"],
                               pair["tr_y"], init_method="keep",
                               cell_bits=4, use_kernel=use_kernel)
    tm, _ = imcsim.multibit_finetune(pair["tm"], 2, pair["tr_x"],
                                     pair["tr_y"], 4, epochs=2,
                                     use_kernel=use_kernel)
    assert_same_am(tm, jm)
    # With code-domain conductance noise, on the reference's fields.
    sim = ImcSimConfig(noise_sigma=0.5, seed=3)
    with jax.disable_jit():
        jm, _ = pair["jm"].fit(jax.random.key(2), pair["tr_x"],
                               pair["tr_y"], init_method="keep",
                               cell_bits=4, noise_sim=jsim(sim),
                               use_kernel=use_kernel)
    tm, _ = pair["tm"].fit(2, pair["tr_x"], pair["tr_y"],
                           init_method="keep", cell_bits=4, noise_sim=sim,
                           use_kernel=use_kernel, noise_sampler=jax_sampler)
    assert_same_am(tm, jm)


def test_imc_artifact_against_reference(pair):
    sim = ImcSimConfig(adc_bits=6, noise_sigma=0.5, fault_p0=0.02,
                       fault_p1=0.01, drift_sigma=1.0, seed=7,
                       arr=ImcArrayConfig(rows=64, cols=128))
    tdep = pair["tm"].deploy(target="imc", sim=sim, sampler=jax_sampler)
    jdep = pair["jm"].deploy(target="imc", sim=jsim(sim))
    np.testing.assert_array_equal(n(tdep.am_analog),
                                  np.asarray(jdep.am_analog))
    np.testing.assert_array_equal(n(tdep.tile_offsets),
                                  np.asarray(jdep.tile_offsets))
    x, y = pair["te_x"], pair["te_y"]
    np.testing.assert_array_equal(n(tdep.predict(x)),
                                  np.asarray(jdep.predict(x)))
    assert tdep.score(x, y, batch=32) == jdep.score(x, y, batch=32)
    assert tdep.cycles == jdep.cycles == 2
    assert tdep.resident_bytes == jdep.resident_bytes
    assert (tdep.backend, tdep.serving_mode) == (jdep.backend,
                                                 jdep.serving_mode)
    assert tdep.imc_cost().am.cycles == jdep.imc_cost().am.cycles
    # refresh re-burns an updated model onto the same device instance.
    tm2, _ = pair["tm"].fit(2, pair["tr_x"], pair["tr_y"],
                            init_method="keep", epochs=1)
    jm2, _ = pair["jm"].fit(jax.random.key(2), pair["tr_x"], pair["tr_y"],
                            init_method="keep", epochs=1)
    t2, j2 = tdep.refresh(tm2), jdep.refresh(jm2)
    np.testing.assert_array_equal(n(t2.am_analog), np.asarray(j2.am_analog))
    np.testing.assert_array_equal(n(t2.predict(x)), np.asarray(j2.predict(x)))


def test_ideal_imc_artifact_equals_the_digital_model(pair):
    dep = pair["tm"].deploy(target="imc")
    x, y = pair["te_x"], pair["te_y"]
    assert dep.sim.ideal and dep.tile_offsets is None
    assert torch.equal(dep.predict(x), pair["tm"].predict(x))
    assert dep.score(x, y) == pair["tm"].score(x, y)
    assert dep.cycles == 1 == dep.imc_cost().am.cycles


def test_multibit_artifact_against_reference(pair):
    sim = ImcSimConfig(adc_bits=8, drift_sigma=2.0, seed=3)
    x, y = pair["te_x"], pair["te_y"]
    for cell_bits, s in ((4, None), (2, sim), (8, sim)):
        tdep = pair["tm"].deploy(target="multibit", cell_bits=cell_bits,
                                 sim=s, sampler=jax_sampler)
        jdep = pair["jm"].deploy(target="multibit", cell_bits=cell_bits,
                                 sim=None if s is None else jsim(s))
        np.testing.assert_array_equal(n(tdep.am_planes_t),
                                      np.asarray(jdep.am_planes_t))
        assert float(tdep.am_scale) == float(jdep.am_scale)
        if s is not None:
            np.testing.assert_array_equal(n(tdep.tile_offsets),
                                          np.asarray(jdep.tile_offsets))
        np.testing.assert_array_equal(n(tdep.predict(x)),
                                      np.asarray(jdep.predict(x)))
        assert tdep.score(x, y, batch=32) == jdep.score(x, y, batch=32)
        q = tdep.encode_query(x) if hasattr(tdep, "encode_query") else \
            pair["tm"].encode_query(x)
        t_idx, t_sim = tdep.search_query(q)
        j_idx, j_sim = jdep.search_query(jnp.asarray(n(q)))
        np.testing.assert_array_equal(n(t_idx), np.asarray(j_idx))
        np.testing.assert_array_equal(n(t_sim), np.asarray(j_sim))
        for attr in ("cycles", "resident_bytes", "memory_bits", "backend",
                     "serving_mode"):
            assert getattr(tdep, attr) == getattr(jdep, attr), attr
        np.testing.assert_array_equal(
            n(am.multibit_predict(tdep.am_planes_t, tdep.centroid_class, q,
                                  cell_bits)),
            np.asarray(jam.multibit_predict(jdep.am_planes_t,
                                            jdep.centroid_class,
                                            jnp.asarray(n(q)), cell_bits)))
    refreshed = tdep.refresh(pair["tm"])
    assert (refreshed.cell_bits, refreshed.sim) == (8, sim)
    assert torch.equal(refreshed.am_planes_t, tdep.am_planes_t)
    with pytest.raises(ValueError, match="outside"):
        pair["tm"].deploy(target="multibit", cell_bits=1)
    with pytest.raises(ValueError, match="1-bit storage"):
        pair["tm"].deploy(target="multibit",
                          sim=ImcSimConfig(noise_sigma=0.1))
    with pytest.raises(ValueError, match="only meaningful"):
        pair["tm"].deploy(target="packed", sim=ImcSimConfig())


# -- refusals (tests/test_imcsim.py's, on the port) ------------------------------

def test_noise_aware_refusals(pair):
    tm = pair["tm"]
    x, y = pair["tr_x"], pair["tr_y"]
    h = torch.zeros((4, 128))
    hb, qb, yb, mask = qail.prebatch(h, h, torch.zeros(4, dtype=torch.int32),
                                     4)
    state, cfg = tm.am_state, tm.am_cfg
    with pytest.raises(ValueError, match="noise_key"):
        qail.qail_epoch_scan(state, cfg, hb, qb, yb, mask,
                             sim=ImcSimConfig(noise_sigma=0.5))
    with pytest.raises(ValueError, match="no-op"):
        imcsim.noise_aware_finetune(tm, 2, x, y, ImcSimConfig(adc_bits=3),
                                    epochs=1)
    with pytest.raises(ValueError, match="batched"):
        tm.fit(2, x, y, mode="sequential",
               noise_sim=ImcSimConfig(noise_sigma=1.0))
    with pytest.raises(ValueError, match="noise_mode"):
        qail.qail_epoch_scan(state, cfg, hb, qb, yb, mask,
                             sim=ImcSimConfig(noise_sigma=0.5), noise_key=1,
                             noise_mode="stale")
    with pytest.raises(ValueError, match="1-bit storage"):
        imcsim.multibit_finetune(tm, 2, x, y, 4, epochs=1,
                                 sim=ImcSimConfig(fault_p0=0.1))
    with pytest.raises(ValueError, match="outside"):
        qail.qail_epoch_scan(state, cfg, hb, qb, yb, mask, cell_bits=9)
    # keep with no epochs keeps the AM.
    kept, hist = tm.fit(2, x, y, init_method="keep", epochs=0)
    assert hist["init"] == [] and torch.equal(kept.am_state["fp"],
                                              tm.am_state["fp"])


# -- the recovery contract (the port alone, its own draws) -----------------------

@pytest.fixture(scope="module")
def trained():
    """The reference's flagship 128x128 fixture, on the port."""
    ds = load_dataset("mnist", train_per_class=150, test_per_class=40,
                      device="cpu")
    enc = types.EncoderConfig(kind="projection", features=ds.features,
                              dim=128)
    amc = types.MemhdConfig(dim=128, columns=128, classes=ds.classes,
                            epochs=6, kmeans_iters=10, lr=0.02)
    from repro_torch.core import MemhdModel
    m, _ = MemhdModel.create(0, enc, amc, device="cpu").fit(
        1, ds.train_x, ds.train_y)
    return ds, m


def test_noise_aware_qail_recovers_half_the_loss(trained):
    """128x128, conductance sigma 0.5, 16-bit ADC, device seed 7:
    chip-in-the-loop noise-aware QAIL recovers >= half of what the
    analog readout lost. A statistical claim, so the port's own draws."""
    ds, m = trained
    rep = imcsim.recovery_experiment(
        m, 2, ds.train_x, ds.train_y, ds.test_x, ds.test_y,
        ImcSimConfig(noise_sigma=0.5, seed=7), epochs=10)
    assert rep["lost"] > 0.05, rep
    assert rep["recovered_frac"] >= 0.5, rep
    assert rep["noisy_accuracy_after"] <= rep["digital_accuracy"] + 0.05


def test_sweeps_and_report(trained):
    ds, m = trained
    x, y = ds.test_x[:120], ds.test_y[:120]
    rows = imcsim.sweep_adc_bits(m, x, y, bits=(16, 2))
    assert [r["adc_bits"] for r in rows] == [16, 2]
    assert rows[0]["accuracy"] >= rows[1]["accuracy"]
    rows = imcsim.sweep_noise_sigma(m, x, y, sigmas=(0.0, 2.0))
    assert rows[0]["accuracy"] > rows[1]["accuracy"]
    rows = imcsim.sweep_fault_rate(m, x, y, rates=(0.0, 0.3))
    assert rows[0]["accuracy"] > rows[1]["accuracy"]
    rep = json.loads(json.dumps(imcsim.robustness_report(
        m, x, y, adc_bits=(16,), noise_sigmas=(0.0,), fault_rates=(0.0,))))
    assert rep["geometry"] == "128x128" and rep["cycles"] == 1
    assert rep["base_sim_accuracy"] == rep["digital_accuracy"]


# -- the CLIs --------------------------------------------------------------------

@pytest.mark.parametrize("argv", [["--target", "imc"],
                                  ["--target", "multibit", "--cell-bits",
                                   "3"]])
def test_serving_cli_device_fidelity_targets(pair, argv):
    ops.reset_dispatch()
    rep = tserve.main(["--smoke", "--device", "cpu", "--requests", "6",
                       "--max-size", "5", *argv])
    target = argv[1]
    jdep = pair["jm"].deploy(target=target, **(
        {"cell_bits": 3} if target == "multibit" else {}))
    jrep = jserve.build_report(jdep, [], {}, 1.0)
    assert set(rep) == set(jrep) | {"cycles"} | {
        k for k in rep if k.startswith(("lat_ms", "service_ms",
                                        "queue_ms"))} | {
        "depth", "batches", "rows_real", "rows_padded", "pad_overhead"}
    assert rep["backend"] == target and rep["cycles"] == 1
    assert rep["mode"] == ("analog" if target == "imc"
                           else "bit-sliced-int3")
    kernel = "am_search_imc" if target == "imc" else "am_search_multibit"
    assert rep["metrics"]["dispatch_tiers"][kernel] == {"torch-ref": 3}


def test_robustness_cli_report_keys(trained, capsys):
    rep = trobust.main(["--smoke", "--device", "cpu", "--adc-bits", "16,4",
                        "--noise-sigmas", "0.0,0.5", "--fault-rates",
                        "0.0,0.05", "--finetune-epochs", "2"])
    assert json.loads(capsys.readouterr().out) == rep
    assert rep["base_sim_accuracy"] == rep["digital_accuracy"]
    # The reference's keys: its report function's, its recovery
    # experiment's, and the CLI's own.
    ds, m = trained
    jrep_keys = {"geometry", "array", "cycles", "digital_accuracy",
                 "base_sim_accuracy", "adc_sweep", "noise_sweep",
                 "fault_sweep", "recovery", "dataset", "wall_s"}
    assert set(rep) == jrep_keys
    assert set(rep["recovery"]) == {
        "digital_accuracy", "noisy_accuracy_before", "noisy_accuracy_after",
        "lost", "recovered", "recovered_frac", "epochs", "noise_sigma",
        "device_seed"}
    assert [r["adc_bits"] for r in rep["adc_sweep"]] == [16, 4]
