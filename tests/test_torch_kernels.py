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
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import encode_fused, ops, pack_bits, ref  # noqa: E402

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


class TestWrapperContract:

    def test_pack_bits_rejects_ragged_width(self):
        with pytest.raises(ValueError, match="multiple of 8"):
            pack_bits.pack_bits(torch.ones((2, 12)))
        with pytest.raises(ValueError, match="multiple of 8"):
            jax_pack_bits(jnp.ones((2, 12)))

    def test_unpack_mode_not_ported(self):
        q = torch.zeros((1, 16), dtype=torch.uint8)
        am_t = torch.zeros((16, 4), dtype=torch.uint8)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            asp.am_search_packed(q, am_t, n_dims=128, mode="unpack")

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
        asp.am_search_packed(ref.pack_rows(x), ref.pack_rows(x).T.contiguous(),
                             n_dims=16)
        assert kernels.launches() == {"pack_bits": 0, "am_search_packed": 0,
                                      "encode_pack": 0}

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
        tiers = ops.dispatch_breakdown()
        # CPU tensors are always served by the plain version.
        assert tiers["encode_pack"] == {"torch-ref": 2}
        assert tiers["pack_rows"] == {"torch-ref": 2}
        assert tiers["am_search_packed"] == {"torch-ref": 2}
        assert tiers["predict_from_features"] == {"torch-ref": 4}
        assert tiers["pack_bits"] == {"torch-ref": 2}
        assert tiers["search_from_features"] == {"torch-ref": 2}
