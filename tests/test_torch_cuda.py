"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU (and nvcc) every test here skips. This
file imports neither jax nor the JAX package, so it runs on a machine
with only the port's dependencies:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import encode_fused, ops, pack_bits, ref  # noqa: E402

pytestmark = pytest.mark.cuda

GEOMS = [(1, 16, 128, 128), (8, 784, 128, 128), (3, 100, 130, 257),
         (5, 617, 512, 300), (2, 64, 120, 26), (1, 9, 9, 3),
         (4, 32, 100, 50), (1024, 784, 1024, 1024)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def bipolar(rng, shape, dev):
    return torch.as_tensor(rng.choice([-1.0, 1.0], size=shape)
                           .astype(np.float32), device=dev)


def feats(rng, shape, dev, dyadic):
    x = rng.random(shape, dtype=np.float32)
    if dyadic:
        x = (np.round(x * 256) / 256).astype(np.float32)
    return torch.as_tensor(x, device=dev)


@pytest.mark.parametrize("b,f,d,c", GEOMS)
def test_pack_bits_and_pack_rows(dev, b, f, d, c):
    rng = np.random.default_rng([1, b, f, d, c])
    x = bipolar(rng, (b, -(-d // 8) * 8), dev)
    assert torch.equal(pack_bits.pack_bits(x), ref.pack_bits(x))
    xr = bipolar(rng, (b, d), dev)
    assert torch.equal(asp.pack_rows(xr), ref.pack_rows(xr))


@pytest.mark.parametrize("b,f,d,c", GEOMS)
@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_am_search_packed_with_ties(dev, b, f, d, c, block_b):
    rng = np.random.default_rng([2, b, f, d, c])
    q = ref.pack_rows(bipolar(rng, (b, d), dev))
    am = bipolar(rng, (c, d), dev)
    for a in (am, am[torch.arange(c, device=dev) % max(1, c // 3)]):
        am_t = ref.pack_rows(a).T.contiguous()
        idx, sim = asp.am_search_packed(q, am_t, n_dims=d, block_b=block_b)
        w_idx, w_sim = ref.am_search_packed(q, am_t, d)
        assert torch.equal(idx, w_idx)
        assert torch.equal(sim, w_sim)


@pytest.mark.parametrize("b,f,d,c", GEOMS)
def test_encode_pack(dev, b, f, d, c):
    rng = np.random.default_rng([3, b, f, d, c])
    proj = bipolar(rng, (f, d), dev)
    xd = feats(rng, (b, f), dev, dyadic=True)
    assert torch.equal(encode_fused.encode_pack(xd, proj),
                       ref.encode_pack(xd, proj))
    # Float features: a sign bit may differ only where |H| <= 1e-5*sum|x|.
    xf = feats(rng, (b, f), dev, dyadic=False)
    got = ref.unpack_bits(encode_fused.encode_pack(xf, proj))[:, :d]
    want = ref.unpack_bits(ref.encode_pack(xf, proj))[:, :d]
    tol = 1e-5 * xf.abs().sum(dim=1, keepdim=True)
    assert not ((got != want) & ((xf @ proj).abs() > tol)).any()


def test_launch_counters_and_cuda_tier(dev):
    rng = np.random.default_rng(4)
    kernels.reset_launches()
    ops.reset_dispatch()
    x, proj = feats(rng, (16, 64), dev, True), bipolar(rng, (64, 128), dev)
    am_t = ref.pack_rows(bipolar(rng, (32, 128), dev)).T.contiguous()
    owners = torch.arange(32, dtype=torch.int32, device=dev) % 10
    q = torch.where(x @ proj >= 0, 1.0, -1.0)
    staged = ops.predict_packed(q, am_t, owners, n_dims=128)
    fused = ops.predict_from_features(x, proj, am_t, owners)
    assert torch.equal(staged, fused)
    assert kernels.launches() == {"pack_bits": 1, "am_search_packed": 2,
                                  "encode_pack": 1}
    assert set(ops.dispatch_breakdown()["am_search_packed"]) == {"cuda"}
    ops.predict_packed(q, am_t, owners, n_dims=128, use_kernel=False)
    assert kernels.launches()["am_search_packed"] == 2  # plain: no launch


def test_wrappers_reject_bad_operands(dev):
    with pytest.raises(TypeError):
        pack_bits.pack_bits(torch.ones((2, 8), dtype=torch.float64,
                                       device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        pack_bits.pack_bits(torch.ones((8, 2), device=dev).T)
    q = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    am_t = torch.zeros((16, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="block_b"):
        asp.am_search_packed(q, am_t, n_dims=128, block_b=7)
    with pytest.raises(TypeError):
        encode_fused.encode_pack(torch.ones((2, 8), device=dev),
                                 torch.ones((8, 8), device=dev).half())
