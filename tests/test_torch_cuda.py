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
from repro_torch.kernels import (  # noqa: E402
    am_search, encode_fused, ops, pack_bits, qail_update, ref,
)

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


@pytest.mark.parametrize("b,f,d,c", GEOMS)
@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_am_search_packed_unpack_mode(dev, b, f, d, c, block_b):
    rng = np.random.default_rng([5, b, f, d, c])
    q = ref.pack_rows(bipolar(rng, (b, d), dev))
    am = bipolar(rng, (c, d), dev)
    for a in (am, am[torch.arange(c, device=dev) % max(1, c // 3)]):
        am_t = ref.pack_rows(a).T.contiguous()
        got = asp.am_search_packed(q, am_t, n_dims=d, block_b=block_b,
                                   mode="unpack")
        pop = asp.am_search_packed(q, am_t, n_dims=d, block_b=block_b)
        want = ref.am_search_packed_unpack(q, am_t, d)
        for g, p, w in zip(got, pop, want):
            assert torch.equal(g, w) and torch.equal(g, p)


@pytest.mark.parametrize("b,f,d,c", GEOMS)
def test_am_search_with_ties_and_views(dev, b, f, d, c):
    rng = np.random.default_rng([6, b, f, d, c])
    am = bipolar(rng, (c, d), dev)
    for a in (am, am[torch.arange(c, device=dev) % max(1, c // 3)]):
        # ±1 and dyadic float queries: exact sums, so bit-equal.
        for q in (bipolar(rng, (b, d), dev),
                  feats(rng, (b, d), dev, dyadic=True) - 0.5):
            want = ref.am_search(q, a.T)
            for am_t in (a.T, a.T.contiguous()):  # a view and a copy
                got = am_search.am_search(q, am_t)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])


QAIL_GEOMS = [(17, 13, 100), (64, 32, 128), (256, 130, 257), (5, 3, 8),
              (33, 128, 512), (256, 1024, 1024)]


def qail_operands(rng, b, c, d, dev, dyadic_lr):
    k = max(2, c // 3)
    q = bipolar(rng, (b, d), dev)
    am_t = bipolar(rng, (d, c), dev)
    owners = torch.as_tensor(rng.integers(0, k, c).astype(np.int32),
                             device=dev)
    labels = rng.integers(0, k + 1, b).astype(np.int32)  # k owns nothing
    mask = (rng.random(b) > 0.2).astype(np.float32)
    labels[-1], mask[-1] = -1, 0.0  # a padded row
    if dyadic_lr:  # a 2^-4 grid, |upd| < 2^10, lr = 2^-4: exact sums
        upd = np.round(np.clip(rng.normal(0, 64, (b, d)), -1000, 1000)
                       * 16) / 16
        lr = 0.0625
    else:
        upd, lr = rng.normal(size=(b, d)), 0.02
    return (q, torch.as_tensor(upd.astype(np.float32), device=dev), am_t,
            owners, torch.as_tensor(labels, device=dev),
            torch.as_tensor(mask, device=dev), lr)


@pytest.mark.parametrize("b,c,d", QAIL_GEOMS)
@pytest.mark.parametrize("dyadic_lr", [True, False])
@pytest.mark.parametrize("block_b", qail_update.BLOCK_B_CHOICES)
def test_qail_update(dev, b, c, d, dyadic_lr, block_b):
    rng = np.random.default_rng([7, b, c, d])
    q, upd, am_t, owners, labels, mask, lr = qail_operands(
        rng, b, c, d, dev, dyadic_lr)
    for at in (am_t, am_t.T.contiguous().T):  # contiguous and a view
        delta, n_miss, pred_t, true_t, mis = qail_update.qail_update_targets(
            q, upd, at, owners, labels, mask, lr=lr, block_b=block_b)
        w_pred, w_true, w_mis = ref.qail_targets(q, at, owners, labels, mask)
        assert torch.equal(pred_t.long(), w_pred)
        assert torch.equal(true_t.long(), w_true)
        assert torch.equal(mis, w_mis)
        w_delta, w_miss = ref.qail_delta(upd, w_pred, w_true, w_mis, lr, c)
        assert n_miss.item() == w_miss.item()
        if dyadic_lr:
            assert torch.equal(delta, w_delta)
        else:  # 2^-20 of the sum of the terms' magnitudes
            w = (lr * w_mis)[:, None] * (
                torch.nn.functional.one_hot(w_true, c)
                - torch.nn.functional.one_hot(w_pred, c)).float()
            tol = 2.0 ** -20 * (w.abs().T @ upd.abs())
            assert ((delta - w_delta).abs() <= tol).all()
        again = qail_update.qail_update(q, upd, at, owners, labels, mask,
                                        lr=lr, block_b=block_b)
        assert torch.equal(again[0], delta)  # no atomics: deterministic


def test_fit_through_the_kernel_equals_the_plain_fit(dev):
    # Dyadic features and lr = 2^-4 with normalize="none": every sum is
    # exact, so the kernel fit and the plain fit agree bit for bit.
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=100, test_per_class=10,
                      device=dev)
    x = torch.round(ds.train_x * 16) / 16
    enc = EncoderConfig(features=784, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=10, lr=0.0625,
                      normalize="none", epochs=3, kmeans_iters=5)
    fits = []
    for use_kernel in (True, False, True):
        kernels.reset_launches()
        m = MemhdModel.create(0, enc, amc, device=dev)
        m, hist = m.fit(1, x, ds.train_y, use_kernel=use_kernel)
        fits.append((m.am_state, hist["curve"],
                     kernels.launches()["qail_update"]))
    assert fits[0][2] == 3 * 4 and fits[1][2] == 0  # 1000 rows, batch 256
    for other in fits[1:]:
        for k in ("fp", "binary"):
            assert torch.equal(fits[0][0][k], other[0][k])
        assert fits[0][1] == other[1]


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
    am = ref.unpack_bits(am_t.T.contiguous())
    unpacked = ops.predict_classes(q, am, owners)
    unpack_mode = ops.predict_packed(q, am_t, owners, n_dims=128,
                                     mode="unpack")
    assert torch.equal(staged, unpacked) and torch.equal(staged, unpack_mode)
    ops.qail_update(q, q, am.T, owners, owners[:16], torch.ones(16,
                                                                device=dev),
                    lr=0.5)
    assert kernels.launches() == {
        "pack_bits": 2, "am_search_packed": 2, "encode_pack": 1,
        "qail_update": 1, "am_search": 1, "am_search_packed_unpack": 1}
    tiers = ops.dispatch_breakdown()
    for name in ("am_search_packed", "am_search", "qail_update"):
        assert set(tiers[name]) == {"cuda"}
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
    with pytest.raises(ValueError, match="block_b"):
        asp.am_search_packed(q, am_t, n_dims=128, block_b=7, mode="unpack")
    x = torch.ones((4, 16), device=dev)
    with pytest.raises(TypeError):
        am_search.am_search(x.double(), x.T)
    with pytest.raises(ValueError, match="contiguous"):
        am_search.am_search(x.T.contiguous().T, x.T)
    own = torch.zeros(3, dtype=torch.int32, device=dev)
    lab = torch.zeros(4, dtype=torch.int32, device=dev)
    msk = torch.ones(4, device=dev)
    with pytest.raises(TypeError):  # labels must be int32
        qail_update.qail_update(x, x, x.T[:, :3], own, lab.long(), msk,
                                lr=0.1)
    with pytest.raises(ValueError, match="different devices"):
        qail_update.qail_update(x, x, x.T[:, :3], own, lab, msk.cpu(),
                                lr=0.1)
