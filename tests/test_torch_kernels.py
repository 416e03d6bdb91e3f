"""The port's serving kernels (plain PyTorch versions) against the JAX
package's Pallas kernels, run as the JAX tests run them on the CPU
(interpret mode).

Inputs come from numpy and feed both packages. Bipolar operands make
every similarity integer-valued, and dyadic features (multiples of
2^-8) make every partial sum of the projection exact, so those
comparisons are bit-exact; float features get a stated tolerance. The
CUDA kernels themselves are held against these plain versions on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.am_search import am_search as jax_am_search  # noqa: E402
from repro.kernels.am_search_packed import (  # noqa: E402
    am_search_packed as jax_am_search_packed,
)
from repro.kernels.am_search_packed import pack_rows as jax_pack_rows  # noqa: E402
from repro.kernels.encode_fused import encode_pack as jax_encode_pack  # noqa: E402
from repro.kernels.encode_fused import (  # noqa: E402
    predict_from_features as jax_predict_from_features,
)
from repro.kernels.encode_fused import (  # noqa: E402
    search_from_features as jax_search_from_features,
)
from repro.kernels.pack_bits import pack_bits as jax_pack_bits  # noqa: E402
from repro.kernels.qail_update import qail_update as jax_qail_update  # noqa: E402
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    am_search, encode_fused, ops, pack_bits, qail_update, ref,
)

# tests/test_kernel_parity.py's GEOMS (batch, features, dim, columns),
# with f capped at 256 to keep interpret mode quick.
GEOMS = [
    (1, 16, 128, 128),
    (8, 256, 128, 128),
    (3, 100, 130, 257),   # D and C just over a tile; Dp = 17
    (5, 256, 512, 300),
    (2, 64, 120, 26),
    (1, 9, 9, 3),         # sub-byte D
]


def rng_for(*key):
    return np.random.default_rng([4321, *key])


def bipolar(rng, shape):
    return rng.choice([-1.0, 1.0], size=shape).astype(np.float32)


def dyadic(rng, shape):
    return (np.round(rng.random(shape) * 256) / 256).astype(np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("b,f,d,c", GEOMS)
class TestAgainstPallas:

    def test_pack_bits(self, b, f, d, c):
        x = bipolar(rng_for(b, f, d, c, 0), (b, -(-d // 8) * 8))
        np.testing.assert_array_equal(n(pack_bits.pack_bits(t(x))),
                                      n(jax_pack_bits(jnp.asarray(x))))

    def test_pack_rows_tail_bits_zero(self, b, f, d, c):
        x = bipolar(rng_for(b, f, d, c, 1), (b, d))
        got = n(asp.pack_rows(t(x)))
        np.testing.assert_array_equal(got, n(jax_pack_rows(jnp.asarray(x))))
        bits = np.unpackbits(got, axis=1, bitorder="little")
        assert not bits[:, d:].any()  # tail bits pack as 0
        np.testing.assert_array_equal(bits[:, :d], (x > 0).astype(np.uint8))

    @pytest.mark.parametrize("ties", [False, True])
    def test_am_search_packed(self, b, f, d, c, ties):
        rng = rng_for(b, f, d, c, 2)
        am = bipolar(rng, (c, d))
        if ties:  # duplicated columns: every query's maximum is tied
            am = am[np.arange(c) % max(1, c // 3)]
        q = ref.pack_rows(t(bipolar(rng, (b, d))))
        am_t = ref.pack_rows(t(am)).T.contiguous()
        idx, sim = asp.am_search_packed(q, am_t, n_dims=d)
        j_idx, j_sim = jax_am_search_packed(jnp.asarray(n(q)),
                                            jnp.asarray(n(am_t)), n_dims=d)
        np.testing.assert_array_equal(n(idx), n(j_idx))
        np.testing.assert_array_equal(n(sim), n(j_sim))
        assert idx.dtype == torch.int32 and sim.dtype == torch.float32
        if ties:  # the lower index wins an equal similarity
            assert (n(idx) < max(1, c // 3)).all()

    @pytest.mark.parametrize("ties", [False, True])
    def test_am_search(self, b, f, d, c, ties):
        # ±1 queries and dyadic float queries: every similarity is an
        # exact float32 sum, so (idx, sim) must be bit-equal.
        rng = rng_for(b, f, d, c, 6)
        am = bipolar(rng, (c, d))
        if ties:
            am = am[np.arange(c) % max(1, c // 3)]
        for q in (bipolar(rng, (b, d)), dyadic(rng, (b, d)) - 0.5):
            idx, sim = am_search.am_search(t(q), t(am).T)
            j_idx, j_sim = jax_am_search(jnp.asarray(q), jnp.asarray(am.T))
            np.testing.assert_array_equal(n(idx), n(j_idx))
            np.testing.assert_array_equal(n(sim), n(j_sim))
            assert idx.dtype == torch.int32 and sim.dtype == torch.float32
            p_idx, p_sim = ops.am_search(t(q), t(am))
            np.testing.assert_array_equal(n(p_idx), n(j_idx))
            np.testing.assert_array_equal(n(p_sim), n(j_sim))
        if ties:
            assert (n(idx) < max(1, c // 3)).all()

    @pytest.mark.parametrize("ties", [False, True])
    def test_am_search_packed_unpack_mode(self, b, f, d, c, ties):
        rng = rng_for(b, f, d, c, 7)
        am = bipolar(rng, (c, d))
        if ties:
            am = am[np.arange(c) % max(1, c // 3)]
        q = ref.pack_rows(t(bipolar(rng, (b, d))))
        am_t = ref.pack_rows(t(am)).T.contiguous()
        idx, sim = asp.am_search_packed(q, am_t, n_dims=d, mode="unpack")
        j_idx, j_sim = jax_am_search_packed(
            jnp.asarray(n(q)), jnp.asarray(n(am_t)), n_dims=d, mode="unpack")
        np.testing.assert_array_equal(n(idx), n(j_idx))
        np.testing.assert_array_equal(n(sim), n(j_sim))
        # Dims past D unpack to 0: the same (idx, sim) as popcount mode,
        # and as the float search over the unpacked ±1 rows.
        p_idx, p_sim = asp.am_search_packed(q, am_t, n_dims=d)
        assert torch.equal(idx, p_idx) and torch.equal(sim, p_sim)
        u = ref.unpack_rows(q, d)
        assert not u[:, d:].any()
        f_idx, f_sim = ref.am_search(u[:, :d], t(am).T)
        assert torch.equal(idx, f_idx) and torch.equal(sim, f_sim)

    def test_encode_pack_dyadic(self, b, f, d, c):
        rng = rng_for(b, f, d, c, 3)
        x, w = dyadic(rng, (b, f)), bipolar(rng, (f, d))
        np.testing.assert_array_equal(
            n(encode_fused.encode_pack(t(x), t(w))),
            n(jax_encode_pack(jnp.asarray(x), jnp.asarray(w))))

    def test_encode_pack_float_within_tolerance(self, b, f, d, c):
        # Float features: summation order may differ between torch and
        # the Pallas K-slab accumulation, so a sign bit may differ only
        # where |H| <= 1e-5 * sum|x| (fp32 rounding of the dot).
        rng = rng_for(b, f, d, c, 4)
        x = rng.random((b, f), dtype=np.float32)
        w = bipolar(rng, (f, d))
        got = np.unpackbits(n(encode_fused.encode_pack(t(x), t(w))), axis=1,
                            bitorder="little")[:, :d]
        want = np.unpackbits(n(jax_encode_pack(jnp.asarray(x),
                                               jnp.asarray(w))),
                             axis=1, bitorder="little")[:, :d]
        h = x.astype(np.float64) @ w.astype(np.float64)
        tol = 1e-5 * np.abs(x).sum(axis=1, keepdims=True)
        assert not ((got != want) & (np.abs(h) > tol)).any()

    def test_search_and_predict_from_features(self, b, f, d, c):
        rng = rng_for(b, f, d, c, 5)
        x, w = dyadic(rng, (b, f)), bipolar(rng, (f, d))
        am_t = ref.pack_rows(t(bipolar(rng, (c, d)))).T.contiguous()
        owners = rng.integers(0, 10, size=c).astype(np.int32)
        idx, sim = encode_fused.search_from_features(t(x), t(w), am_t)
        j_idx, j_sim = jax_search_from_features(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(n(am_t)))
        np.testing.assert_array_equal(n(idx), n(j_idx))
        np.testing.assert_array_equal(n(sim), n(j_sim))
        cls = encode_fused.predict_from_features(t(x), t(w), am_t,
                                                 t(owners))
        np.testing.assert_array_equal(
            n(cls), n(jax_predict_from_features(
                jnp.asarray(x), jnp.asarray(w), jnp.asarray(n(am_t)),
                jnp.asarray(owners))))


# The reference's own qail_update GEOMS (b, c, d),
# tests/test_qail_engine.py::TestQailUpdateKernel.
QAIL_GEOMS = [(17, 13, 100), (64, 32, 128), (256, 130, 257), (5, 3, 8),
              (33, 128, 512)]


def qail_operands(b, c, d, dyadic_lr):
    """Seeded operands: ±1 queries and AM, padded last row (label -1,
    mask 0), a class that owns no centroid, and a payload on a 2^-4 grid
    (|upd| < 2^10) when ``dyadic_lr``, else float normal."""
    rng = rng_for(b, c, d, 11)
    k = max(2, c // 3)
    q = bipolar(rng, (b, d))
    am_t = bipolar(rng, (d, c))
    owners = rng.integers(0, k, size=c).astype(np.int32)
    labels = rng.integers(0, k + 1, size=b).astype(np.int32)  # k: no owner
    mask = (rng.random(b) > 0.2).astype(np.float32)
    labels[-1], mask[-1] = -1, 0.0
    if dyadic_lr:
        upd = (np.round(rng.normal(0, 8, (b, d)) * 16) / 16).astype(
            np.float32)
        return q, upd, am_t, owners, labels, mask, 0.0625
    return (q, rng.normal(size=(b, d)).astype(np.float32), am_t, owners,
            labels, mask, 0.02)


def qail_tolerance(upd, w):
    """|delta error| allowed at a non-dyadic lr: 2^-20 of the sum of the
    terms' magnitudes (fp32 summation-order rounding over <= B terms)."""
    return 2.0 ** -20 * (np.abs(w).T @ np.abs(upd))


@pytest.mark.parametrize("b,c,d", QAIL_GEOMS)
@pytest.mark.parametrize("dyadic_lr", [True, False])
def test_qail_update_against_pallas(b, c, d, dyadic_lr):
    q, upd, am_t, owners, labels, mask, lr = qail_operands(b, c, d,
                                                           dyadic_lr)
    ops_in = [t(x) for x in (q, upd, am_t, owners, labels, mask)]
    got, got_miss = ref.qail_update_delta(*ops_in, lr)
    j_in = [jnp.asarray(x) for x in (q, upd, am_t, owners, labels, mask)]
    j_ref, j_ref_miss = jax_ref.qail_update_delta(*j_in, lr)
    j_ker, j_ker_miss = jax_qail_update(*j_in, lr=lr)
    assert float(got_miss) == float(j_ref_miss) == float(j_ker_miss)
    pred_t, true_t, mis = ref.qail_targets(*ops_in[:1], ops_in[2],
                                           *ops_in[3:])
    w = n((lr * mis)[:, None] * (torch.nn.functional.one_hot(true_t, c)
                                 - torch.nn.functional.one_hot(pred_t, c)))
    assert (n(true_t)[labels == max(2, c // 3)] == 0).all()  # no owner
    assert not w[-1].any()  # the padded row adds nothing
    for want in (n(j_ref), n(j_ker)):
        if dyadic_lr:  # every partial sum exact: bit-equal
            np.testing.assert_array_equal(n(got), want)
        else:
            assert (np.abs(n(got) - want) <= qail_tolerance(upd, w)).all()
    # The wrapper and the dispatch take the same plain path on the CPU.
    for delta, miss in (qail_update.qail_update(*ops_in, lr=lr),
                        ops.qail_update(*ops_in, lr=lr),
                        ops.qail_update(*ops_in, lr=lr, use_kernel=False)):
        assert torch.equal(delta, got) and float(miss) == float(got_miss)


class TestWrapperContract:

    def test_pack_bits_rejects_ragged_width(self):
        with pytest.raises(ValueError, match="multiple of 8"):
            pack_bits.pack_bits(torch.ones((2, 12)))
        with pytest.raises(ValueError, match="multiple of 8"):
            jax_pack_bits(jnp.ones((2, 12)))

    def test_unpack_mode_not_ported(self):
        """The name dates from before the unpack mode was ported. It now
        checks that the mode returns the popcount mode's (idx, sim), and
        that a mode neither package has is refused."""
        rng = rng_for(8)
        q = ref.pack_rows(t(bipolar(rng, (3, 100))))
        am_t = ref.pack_rows(t(bipolar(rng, (7, 100)))).T.contiguous()
        got = asp.am_search_packed(q, am_t, n_dims=100, mode="unpack")
        want = asp.am_search_packed(q, am_t, n_dims=100)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        with pytest.raises(ValueError, match="mode"):
            asp.am_search_packed(q, am_t, n_dims=100, mode="xor")

    def test_inconsistent_n_dims_rejected(self):
        q = torch.zeros((1, 16), dtype=torch.uint8)
        am_t = torch.zeros((16, 4), dtype=torch.uint8)
        with pytest.raises(ValueError, match="n_dims"):
            asp.am_search_packed(q, am_t, n_dims=100)

    def test_cpu_tensors_never_launch(self):
        from repro_torch import kernels
        kernels.reset_launches()
        x = torch.ones((4, 16))
        pack_bits.pack_bits(x)
        encode_fused.encode_pack(torch.ones((4, 8)), torch.ones((8, 16)))
        for mode in asp.MODES:
            asp.am_search_packed(ref.pack_rows(x),
                                 ref.pack_rows(x).T.contiguous(), n_dims=16,
                                 mode=mode)
        am_search.am_search(x, x.T)
        qail_update.qail_update(x, x, x.T, torch.zeros(4, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int32),
                                torch.ones(4), lr=0.5)
        assert kernels.launches() == {
            "pack_bits": 0, "am_search_packed": 0, "encode_pack": 0,
            "qail_update": 0, "am_search": 0, "am_search_packed_unpack": 0}

    def test_new_wrappers_reject_bad_operands(self):
        x = torch.ones((4, 16))
        own, lab, msk = (torch.zeros(3, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32), torch.ones(4))
        with pytest.raises(ValueError, match="shapes differ"):
            qail_update.qail_update(x, x[:, :8], x.T[:, :3], own, lab, msk,
                                    lr=0.1)
        with pytest.raises(ValueError, match="centroid_class"):
            qail_update.qail_update(x, x, x.T[:, :3], own[:2], lab, msk,
                                    lr=0.1)
        with pytest.raises(ValueError, match="no columns"):
            am_search.am_search(x, x.T[:, :0])
        with pytest.raises(ValueError, match="widths differ"):
            am_search.am_search(x, x.T[:8])
        with pytest.raises(ValueError, match="block_b"):
            ops.qail_update(x, x, x.T[:, :3], own, lab, msk, lr=0.1,
                            block_b=0)
        with pytest.raises(ValueError, match="block_b"):
            qail_update.qail_update(x, x, x.T[:, :3], own, lab, msk, lr=0.1,
                                    block_b=24)

    def test_unpack_bits_roundtrip(self):
        x = t(bipolar(rng_for(9), (3, 24)))
        np.testing.assert_array_equal(n(pack_bits.unpack_bits(
            pack_bits.pack_bits(x))), n(x))


class TestDispatch:

    def test_tiers_and_counts(self):
        ops.reset_dispatch()
        rng = rng_for(7)
        x, w = dyadic(rng, (4, 16)), bipolar(rng, (16, 24))
        am_t = ref.pack_rows(t(bipolar(rng, (5, 24)))).T.contiguous()
        owners = torch.arange(5, dtype=torch.int32)
        q = ref.binary_mvm(t(x), t(w)) >= 0
        qb = torch.where(q, 1.0, -1.0)
        for use_kernel in (True, False):
            ops.encode_pack(t(x), t(w), use_kernel=use_kernel)
            ops.search_from_features(t(x), t(w), am_t,
                                     use_kernel=use_kernel)
            ops.predict_from_features(t(x), t(w), am_t, owners,
                                      use_kernel=use_kernel)
            got = ops.predict_packed(qb, am_t, owners, n_dims=24,
                                     use_kernel=use_kernel)
            ops.pack_bits(qb, use_kernel=use_kernel)
            np.testing.assert_array_equal(
                n(got), n(ops.predict_from_features(t(x), t(w), am_t,
                                                    owners)))
        for use_kernel in (True, False):
            ops.am_search(qb, t(bipolar(rng, (5, 24))), use_kernel=use_kernel)
            ops.predict_classes(qb, t(bipolar(rng, (5, 24))), owners,
                                use_kernel=use_kernel)
            ops.am_search_packed(ref.pack_rows(qb), am_t, n_dims=24,
                                 mode="unpack", use_kernel=use_kernel)
            ops.qail_update(qb, qb, t(bipolar(rng, (24, 5))), owners,
                            owners[:4], torch.ones(4), lr=0.5,
                            use_kernel=use_kernel)
        tiers = ops.dispatch_breakdown()
        assert tiers["am_search"] == {"torch-ref": 4}
        assert tiers["qail_update"] == {"torch-ref": 2}
        # CPU tensors are always served by the plain version.
        assert tiers["encode_pack"] == {"torch-ref": 2}
        assert tiers["pack_rows"] == {"torch-ref": 2}
        assert tiers["am_search_packed"] == {"torch-ref": 4}
        assert tiers["predict_from_features"] == {"torch-ref": 4}
        assert tiers["pack_bits"] == {"torch-ref": 2}
        assert tiers["search_from_features"] == {"torch-ref": 2}
