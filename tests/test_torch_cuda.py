"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a GPU (and nvcc) every test here skips. This
file imports neither jax nor the JAX package, so it runs on a machine
with only the port's dependencies:

    PYTHONPATH=src python -m pytest -p no:cacheprovider --noconftest \
        tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels import am_search_packed as asp  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    am_search, am_search_imc, am_search_multibit, am_search_sparse,
    am_shortlist, binary_mvm, encode_fused, flash_decode, ops, pack_bits,
    qail_update, ref, ssd_chunk,
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


@pytest.mark.parametrize("r,c", [(1, 8), (3, 8), (5, 136), (17, 1000),
                                 (129, 1024), (1030, 1016), (8500, 1024)])
def test_pack_and_unpack_every_chunk_tail_and_byte(dev, r, c):
    """pack_bits at unaligned R and C (whole chunks, a ragged last chunk,
    more chunks than the grid holds), pack_rows at a ragged D, and
    unpack_bits over every byte value, from aligned and misaligned
    views."""
    rng = np.random.default_rng([35, r, c])
    x = bipolar(rng, (r, c), dev)
    assert torch.equal(pack_bits.pack_bits(x), ref.pack_bits(x))
    xr = bipolar(rng, (r, c - 3), dev)
    assert torch.equal(asp.pack_rows(xr), ref.pack_rows(xr))
    p = torch.as_tensor(rng.integers(0, 256, (r, c // 8), dtype=np.uint8),
                        device=dev)
    n = min(256, p.numel())
    p.view(-1)[:n] = torch.arange(n, device=dev).to(torch.uint8)
    assert torch.equal(pack_bits.unpack_bits(p), ref.unpack_bits(p))
    off = torch.empty(p.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    off.copy_(p.view(-1))
    assert off.data_ptr() % 4 == 1
    assert torch.equal(pack_bits.unpack_bits(off.view(r, c // 8)),
                       ref.unpack_bits(p))


@pytest.mark.parametrize("fn", ["pack", "unpack"])
@pytest.mark.parametrize("field,delta", [("grid", 1), ("threads", 32),
                                         ("sms", 1)])
def test_pack_bits_launchers_refuse_another_plan(dev, monkeypatch, fn, field,
                                                 delta):
    x = torch.ones((64, 1024), device=dev)
    p = ref.pack_bits(x)
    run = ((lambda: pack_bits.pack_bits(x)) if fn == "pack"
           else (lambda: pack_bits.unpack_bits(p)))
    real = pack_bits.launch_plan
    monkeypatch.setattr(pack_bits, "launch_plan", lambda *a: {
        **real(*a), field: real(*a)[field] + delta})
    with pytest.raises(RuntimeError, match="cudaError_t"):
        run()


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


def unpack_equal_three_ways(q, am_t, d, block_b):
    got = asp.am_search_packed(q, am_t, n_dims=d, block_b=block_b,
                               mode="unpack")
    pop = asp.am_search_packed(q, am_t, n_dims=d, block_b=block_b)
    want = ref.am_search_packed_unpack(q, am_t, d)
    for g, p, w in zip(got, pop, want):
        assert torch.equal(g, w) and torch.equal(g, p)
    return got


@pytest.mark.parametrize("c", [1, 127, 129, 1000])
@pytest.mark.parametrize("d", [8, 100, 1000, 1024])
@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_unpack_mode_tails_of_b_c_and_d(dev, c, d, block_b):
    """C, D and B tails of the tensor-core tiles (B 1 and 1,023, C not a
    multiple of the 128-column split, D = 100 with Dp = 13): the unpack
    mode equals popcount mode and the plain version bit for bit."""
    rng = np.random.default_rng([18, c, d, block_b])
    am_t = ref.pack_rows(bipolar(rng, (c, d), dev)).T.contiguous()
    for b in (1, 1023):
        unpack_equal_three_ways(ref.pack_rows(bipolar(rng, (b, d), dev)),
                                am_t, d, block_b)


@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_unpack_mode_ties_across_column_splits(dev, block_b):
    """Exact copies of a query in several 128-column splits (blocks that
    finish in any order): the lowest index wins, whether it lies in the
    first split or in a later one than the others' copies."""
    rng = np.random.default_rng([18, block_b])
    d, c, b = 1024, 1024, 300
    am = bipolar(rng, (c, d), dev)
    q = bipolar(rng, (b, d), dev)
    i = torch.arange(40, device=dev)
    win = 130 + 3 * i                      # split 1
    for cols in (win, win + 470, win + 640):  # splits 1, 4-5, 6
        am[cols] = q[:40]
    am[1 + 3 * i[:20]] = q[:20]            # split 0, for rows 0-19
    got, _ = unpack_equal_three_ways(ref.pack_rows(q),
                                     ref.pack_rows(am).T.contiguous(), d,
                                     block_b)
    want = torch.where(i < 20, 1 + 3 * i, win).to(torch.int32)
    assert torch.equal(got[:40], want)


def test_packed_fold_scratch_is_left_all_ones(dev):
    """Both modes leave the stream's fold scratch (keys, tickets) all ones,
    so launches of any B, block_b and mode in a row, with no memset
    between them, each equal the plain version."""
    rng = np.random.default_rng(19)
    am_t = ref.pack_rows(bipolar(rng, (300, 200), dev)).T.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b, block_b, mode in ((70, 8, "popcount"), (1, 32, "unpack"),
                             (300, 4, "popcount"), (33, 16, "unpack"),
                             (1, 8, "popcount"), (300, 32, "popcount")):
        q = ref.pack_rows(bipolar(rng, (b, 200), dev))
        got = asp.am_search_packed(q, am_t, n_dims=200, block_b=block_b,
                                   mode=mode)
        want = ref.am_search_packed(q, am_t, 200)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        buf = asp.fold_scratch(dev, stream, 0)
        assert bool((buf == 255).all())


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("block_b", asp.BLOCK_B_CHOICES)
def test_popcount_ties_across_column_splits_at_a_served_batch(dev, b,
                                                              block_b):
    """B = 1 and B = 32 (a served request), where popcount mode splits C
    into 8-column splits (one warp a block): exact copies of a query in
    several splits, the lowest index wins wherever it lies; both modes
    equal the plain version."""
    rng = np.random.default_rng([20, b, block_b])
    d, c = 1024, 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert asp.launch_plan(b, d // 8, c, block_b, "popcount",
                           sms)["cols"] == 8
    am = bipolar(rng, (c, d), dev)
    q = bipolar(rng, (b, d), dev)
    i = torch.arange(b, device=dev)
    win = 130 + 3 * i
    for cols in (win, win + 470, win + 640):
        am[cols] = q
    early = i[i % 2 == 0]
    am[1 + 3 * early] = q[early]  # rows with an even index: split 0 wins
    got, _ = unpack_equal_three_ways(ref.pack_rows(q),
                                     ref.pack_rows(am).T.contiguous(), d,
                                     block_b)
    want = torch.where(i % 2 == 0, 1 + 3 * i, win).to(torch.int32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,f,d,c", GEOMS)
def test_am_search_with_ties_and_views(dev, b, f, d, c):
    """±1 queries take the int8 route and dyadic float queries the fp32
    route (one count per call); both equal the plain version bit for bit,
    ties (duplicated columns) included, through the transposed view of the
    resident AM and through a contiguous (D, C) copy."""
    rng = np.random.default_rng([6, b, f, d, c])
    am = bipolar(rng, (c, d), dev)
    for a in (am, am[torch.arange(c, device=dev) % max(1, c // 3)]):
        # ±1 and dyadic float queries: exact sums, so bit-equal.
        for q, route in ((bipolar(rng, (b, d), dev), "int8"),
                         (feats(rng, (b, d), dev, dyadic=True) - 0.5,
                          "fp32")):
            want = ref.am_search(q, a.T)
            assert am_search.int8_route(q, a.T) == (route == "int8")
            for am_t in (a.T, a.T.contiguous()):  # a view and a copy
                am_search.reset_routes()
                got = am_search.am_search(q, am_t)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
                counts = {"int8": 0, "fp32": 0}
                counts[route] = 1
                assert am_search.route_counts() == counts


def test_am_search_misaligned_queries_and_unsafe_sums(dev):
    """A query view 4 bytes off a 16-byte boundary takes 4-byte copies on
    the fp32 route and the int8 route's convert pass its transposing
    path; integer operands whose dot could pass 2^24 (127 * 127 * 1100
    dims) take the fp32 route; all equal the plain version."""
    rng = np.random.default_rng(42)
    b, d, c = 7, 1100, 90
    base = torch.as_tensor(rng.choice([-1.0, 1.0], b * d + 1)
                           .astype(np.float32), device=dev)
    q = base[1:].view(b, d)
    am = bipolar(rng, (c, d), dev)
    half = 0.5 * q
    for qq, a, route in ((q, am, "int8"), (half, am, "fp32"),
                         (127 * q.contiguous(), 127 * am, "fp32")):
        assert am_search.int8_route(qq, a.T) == (route == "int8")
        am_search.reset_routes()
        got = am_search.am_search(qq, a.T)
        want = ref.am_search(qq, a.T)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        counts = {"int8": 0, "fp32": 0}
        counts[route] = 1
        assert am_search.route_counts() == counts


@pytest.mark.parametrize("field,delta", [
    ("grid", (1, 0)), ("grid", (0, 1)), ("threads", 32), ("smem", 16),
    ("slabs", 1), ("k_stages", 1), ("k_steps", 1), ("conv_grid", 1),
    ("scratch_bytes", 256)])
def test_am_search_launcher_refuses_another_plan(dev, monkeypatch, field,
                                                 delta):
    """The launcher takes the wrapper's launch_plan and refuses one that is
    not its own grid, threads, shared memory, slab walk (one slab of D),
    convert grid or scratch."""
    rng = np.random.default_rng(44)
    q = bipolar(rng, (70, 200), dev)
    am = bipolar(rng, (130, 200), dev)
    am_search.am_search(q, am.T)  # the plan as computed
    plan = am_search.launch_plan(70, 200, 130)
    bad = dict(plan)
    if field == "grid":
        bad["grid"] = tuple(v + dv for v, dv in zip(plan["grid"], delta))
    else:
        bad[field] = plan[field] + delta
    monkeypatch.setattr(am_search, "launch_plan", lambda *a: bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        am_search.am_search(q, am.T)


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


def qail_exact(dev, q, upd, am_t, owners, labels, mask, lr, block_b,
               route):
    """qail_update_targets on ``route``, bit-equal to the plain version
    (lr and upd dyadic: every delta sum exact)."""
    c = am_t.shape[1]
    qail_update.reset_routes()
    delta, n_miss, pred_t, true_t, mis = qail_update.qail_update_targets(
        q, upd, am_t, owners, labels, mask, lr=lr, block_b=block_b)
    w_pred, w_true, w_mis = ref.qail_targets(q, am_t, owners, labels, mask)
    w_delta, w_miss = ref.qail_delta(upd, w_pred, w_true, w_mis, lr, c)
    assert torch.equal(pred_t.long(), w_pred)
    assert torch.equal(true_t.long(), w_true)
    assert torch.equal(mis, w_mis)
    assert n_miss.item() == w_miss.item()
    assert torch.equal(delta, w_delta)
    want = {"int8": 0, "fp32": 0}
    want[route] = 1
    assert qail_update.route_counts() == want


@pytest.mark.parametrize("b,c,d", [(17, 13, 13), (64, 130, 100),
                                   (33, 257, 257), (5, 3, 8),
                                   (300, 65, 129), (256, 1024, 1024)])
@pytest.mark.parametrize("codes", [1, 7, 127])
@pytest.mark.parametrize("block_b", qail_update.BLOCK_B_CHOICES)
def test_qail_update_int8_route_is_exact(dev, b, c, d, codes, block_b):
    """±1 queries against a ±1 AM or multi-bit codes in [-codes, codes]:
    the int8 route, bit-equal to the plain version, through a contiguous
    (D, C) AM, the transposed view of a (C, D) AM and a tie-heavy AM
    (duplicated columns)."""
    rng = np.random.default_rng([17, b, c, d, codes])
    q, upd, _, owners, labels, mask, lr = qail_operands(rng, b, c, d, dev,
                                                        True)
    am = torch.as_tensor(rng.integers(-codes, codes + 1, (c, d))
                         .astype(np.float32), device=dev)
    if codes == 1:
        am = torch.where(am >= 0, 1.0, -1.0)
    am[0, 0] = float(codes)  # the largest code is present
    dup = am[torch.arange(c, device=dev) % max(1, c // 3)]
    for am_t in (am.T.contiguous(), am.T, dup.T):
        qail_exact(dev, q, upd, am_t, owners, labels, mask, lr, block_b,
                   "int8")


@pytest.mark.parametrize("value", [0.5, 128.0, -129.0])
@pytest.mark.parametrize("block_b", qail_update.BLOCK_B_CHOICES)
def test_qail_update_takes_the_fp32_route_off_int8(dev, value, block_b):
    """One AM element that is not an integer in [-127, 127] sends the
    call through the fp32 route, still equal to the plain version."""
    rng = np.random.default_rng([18, block_b])
    b, c, d = 96, 130, 257
    q, upd, am_t, owners, labels, mask, lr = qail_operands(rng, b, c, d, dev,
                                                           True)
    am_t = am_t.clone()
    am_t[d // 2, c // 2] = value
    qail_exact(dev, q, upd, am_t, owners, labels, mask, lr, block_b, "fp32")
    qail_exact(dev, q, upd, am_t.T.contiguous().T, owners, labels, mask, lr,
               block_b, "fp32")


def test_qail_update_int8_route_needs_exact_sums(dev):
    """Codes of 127 on both sides over D = 1,041 dims can reach
    127 * 127 * D > 2^24, where float32 sums round: the fp32 route."""
    rng = np.random.default_rng(19)
    b, c, d = 32, 64, 1041
    _, upd, _, owners, labels, mask, lr = qail_operands(rng, b, c, d, dev,
                                                        True)
    q = torch.as_tensor(rng.integers(-127, 128, (b, d)).astype(np.float32),
                        device=dev)
    am_t = torch.as_tensor(rng.integers(-127, 128, (d, c))
                           .astype(np.float32), device=dev)
    q[0, 0] = am_t[0, 0] = 127.0
    qail_update.reset_routes()
    qail_update.qail_update(q, upd, am_t, owners, labels, mask, lr=lr)
    assert qail_update.route_counts() == {"int8": 0, "fp32": 1}
    qail_exact(dev, q[:, :1040].contiguous(), upd[:, :1040].contiguous(),
               am_t[:1040], owners, labels, mask, lr, 32, "int8")


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
        "qail_update": 1, "am_search": 1, "am_search_packed_unpack": 1,
        "binary_mvm": 0, "unpack_bits": 0, "am_search_imc": 0,
        "am_search_multibit": 0, "am_shortlist": 0, "am_search_sparse": 0,
        "am_search_sparse_gathered": 0, "flash_decode": 0, "ssd_chunk": 0}
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


@pytest.mark.parametrize("b,f,d,c", GEOMS)
def test_binary_mvm_and_unpack_bits(dev, b, f, d, c):
    rng = np.random.default_rng([7, b, f, d, c])
    w = bipolar(rng, (f, d), dev)
    xd = feats(rng, (b, f), dev, True)
    assert torch.equal(binary_mvm.binary_mvm(xd, w), xd @ w)  # exact
    xf = feats(rng, (b, f), dev, False)
    err = (binary_mvm.binary_mvm(xf, w) - xf @ w).abs()
    assert (err <= 2.0 ** -20 * (xf.abs() @ w.abs())).all()
    p = torch.as_tensor(rng.integers(0, 256, (b, -(-d // 8)),
                                     dtype=np.uint8), device=dev)
    assert torch.equal(pack_bits.unpack_bits(p), ref.unpack_bits(p))


@pytest.mark.parametrize("b,f,d,c", GEOMS)
@pytest.mark.parametrize("rows,cols", [(128, 128), (64, 128), (256, 128)])
def test_am_search_imc_and_multibit(dev, b, f, d, c, rows, cols):
    # Bipolar queries: the plain version sums each slab in the kernel's
    # row order, so both agree bit for bit even on a float-noise AM.
    rng = np.random.default_rng([8, b, d, c, rows])
    q = bipolar(rng, (b, d), dev)
    am = bipolar(rng, (c, d), dev)
    am = am[torch.arange(c, device=dev) % max(1, c // 3)]
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                        device=dev)
    gd, gc = -(-d // rows), -(-c // cols)
    off = torch.as_tensor((np.round(rng.normal(0, 2, (gd, gc)) * 16) / 16)
                          .astype(np.float32), device=dev)
    for a in (am, am + 0.5 * torch.round(z * 64) / 64, am + 0.5 * z):
        for bits in (16, 6, 3):
            for o in (None, off):
                kw = dict(tile_rows=rows, tile_cols=cols, adc_bits=bits,
                          adc_clip=float(rows))
                got = am_search_imc.am_search_imc(q, a.T, o, **kw)
                want = ref.am_search_imc(q, a.T, offsets=o, **kw)
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
    for cb in range(2, 9):
        qmax = 2 ** (cb - 1) - 1
        codes = torch.as_tensor(rng.integers(-qmax, qmax + 1, (c, d)),
                                device=dev)
        planes = ref.pack_planes(codes + qmax, cb)
        for adc, o in ((16, None), (4, off)):
            kw = dict(cell_bits=cb, tile_rows=rows, tile_cols=cols,
                      adc_bits=adc)
            got = am_search_multibit.am_search_multibit(q, planes, o, **kw)
            want = ref.am_search_multibit(q, planes, offsets=o, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


IMC_ROUTE_GEOMS = [(3, 130, 257, 128), (5, 100, 50, 40), (2, 9, 3, 256),
                   (4, 300, 70, 7), (64, 256, 130, 100),
                   (1024, 1024, 1024, 128)]


@pytest.mark.parametrize("b,d,c,rows", IMC_ROUTE_GEOMS)
@pytest.mark.parametrize("noise,route", [("pm1", "int8"),
                                         ("dyadic", "fp32"),
                                         ("float", "fp32")])
def test_am_search_imc_routes_are_bit_exact(dev, b, d, c, rows, noise,
                                            route):
    """A ±1 AM takes the int8 route, a dyadic- or sigma 0.5-noise AM the
    fp32 route (one count per call), and both equal the plain version bit
    for bit over ±1 queries, at array heights that cut 32-dim k steps,
    with and without offsets (without, at a power-of-two step, the int8
    route closes slabs in integer counts of steps), through the transposed
    view and through a contiguous (D, C) AM (4-byte copies)."""
    rng = np.random.default_rng([40, b, d, c, rows])
    q = bipolar(rng, (b, d), dev)
    am = bipolar(rng, (c, d), dev)[torch.arange(c, device=dev) % max(1, c // 3)]
    z = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                        device=dev)
    if noise == "dyadic":
        am = am + 0.5 * torch.round(z * 64) / 64
    elif noise == "float":
        am = am + 0.5 * z
    gd, gc = -(-d // rows), -(-c // 32)
    off = torch.as_tensor((np.round(rng.normal(0, 2, (gd, gc)) * 16) / 16)
                          .astype(np.float32), device=dev)
    assert am_search_imc.int8_route(q, am.T, rows) == (route == "int8")
    for at in (am.T, am.T.contiguous()):
        for bits, o in ((16, None), (6, off), (3, off), (3, None)):
            kw = dict(tile_rows=rows, tile_cols=32, adc_bits=bits,
                      adc_clip=float(rows))
            am_search_imc.reset_routes()
            got = am_search_imc.am_search_imc(q, at, o, **kw)
            want = ref.am_search_imc(q, at, offsets=o, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            counts = {"int8": 0, "fp32": 0}
            counts[route] = 1
            assert am_search_imc.route_counts() == counts


def test_am_search_imc_misaligned_queries_and_unsafe_sums(dev):
    """On the fp32 route, a query view 4 bytes off a 16-byte boundary
    takes 4-byte copies; integer operands whose slab partial could pass
    2^24 (127 * 127 * 1100 rows) take the fp32 route; both equal the plain
    version."""
    rng = np.random.default_rng(41)
    b, d, c = 7, 1100, 90
    base = torch.as_tensor(rng.choice([-1.0, 1.0], b * d + 1)
                           .astype(np.float32), device=dev)
    q = base[1:].view(b, d)
    am = bipolar(rng, (c, d), dev)
    noisy = am + 0.5 * torch.as_tensor(rng.normal(size=(c, d)),
                                       dtype=torch.float32, device=dev)
    kw = dict(tile_rows=128, tile_cols=128, adc_bits=6, adc_clip=128.0)
    am_search_imc.reset_routes()
    got = am_search_imc.am_search_imc(q, noisy.T, **kw)
    want = ref.am_search_imc(q, noisy.T, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert am_search_imc.route_counts() == {"int8": 0, "fp32": 1}
    q127, am127 = 127 * q.contiguous(), 127 * am
    kw = dict(tile_rows=1100, tile_cols=128, adc_bits=16, adc_clip=2.0 ** 24)
    assert not am_search_imc.int8_route(q127, am127.T, 1100)
    am_search_imc.reset_routes()
    got = am_search_imc.am_search_imc(q127, am127.T, **kw)
    want = ref.am_search_imc(q127, am127.T, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert am_search_imc.route_counts() == {"int8": 0, "fp32": 1}


@pytest.mark.parametrize("cell_bits", range(2, 9))
@pytest.mark.parametrize("b,d,c,rows", [(3, 130, 257, 128), (5, 100, 48, 40),
                                        (2, 9, 3, 8), (70, 1024, 300, 256)])
def test_am_search_multibit_routes_are_bit_exact(dev, cell_bits, b, d, c,
                                                 rows):
    """±1 queries take the int8 route (u8 codes over all of [0, 2^b - 1]),
    dyadic non-integer queries and a query of 200 the fp32 route; every
    call equals the plain version bit for bit, one route count a call."""
    rng = np.random.default_rng([42, cell_bits, b, d, c, rows])
    u = rng.integers(0, 2 ** cell_bits, (c, d))
    u[0] = 2 ** cell_bits - 1
    planes = ref.pack_planes(torch.as_tensor(u, device=dev), cell_bits)
    q = bipolar(rng, (b, d), dev)
    dy = torch.as_tensor(np.round(rng.normal(0, 2, (b, d)) * 4) / 4,
                         dtype=torch.float32, device=dev)
    big = q.clone()
    big[0, 0] = 200.0
    gd, gc = -(-d // rows), -(-c // 16)
    off = torch.as_tensor((np.round(rng.normal(0, 4, (gd, gc)) * 16) / 16)
                          .astype(np.float32), device=dev)
    for qq, route in ((q, "int8"), (dy, "fp32"), (big, "fp32")):
        assert am_search_multibit.int8_route(qq, cell_bits, rows) == (
            route == "int8")
        for adc, o in ((16, None), (4, off), (4, None)):
            kw = dict(cell_bits=cell_bits, tile_rows=rows, tile_cols=16,
                      adc_bits=adc)
            am_search_multibit.reset_routes()
            got = am_search_multibit.am_search_multibit(qq, planes, o, **kw)
            want = ref.am_search_multibit(qq, planes, offsets=o, **kw)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
            counts = {"int8": 0, "fp32": 0}
            counts[route] = 1
            assert am_search_multibit.route_counts() == counts


ADC_FIELDS = [("grid", (1, 0)), ("grid", (0, 1)), ("threads", 32),
              ("smem", 16), ("slabs", 1), ("k_stages", 1), ("k_steps", 1),
              ("conv_grid", 1), ("scratch_bytes", 256)]


@pytest.mark.parametrize("kernel", ["imc", "multibit"])
@pytest.mark.parametrize("field,delta", ADC_FIELDS)
def test_adc_launchers_refuse_another_plan(dev, monkeypatch, kernel, field,
                                           delta):
    """Both launchers take the wrapper's launch_plan and refuse one that
    is not their own grid, threads, shared memory, slab walk, convert
    grid or scratch."""
    rng = np.random.default_rng(43)
    q = bipolar(rng, (70, 200), dev)
    if kernel == "imc":
        mod, am = am_search_imc, bipolar(rng, (130, 200), dev).T

        def run():
            return am_search_imc.am_search_imc(q, am, tile_rows=100,
                                               tile_cols=64)
    else:
        mod = am_search_multibit
        planes = ref.pack_planes(torch.as_tensor(
            rng.integers(0, 16, (130, 200)), device=dev), 4)

        def run():
            return am_search_multibit.am_search_multibit(
                q, planes, cell_bits=4, tile_rows=64, tile_cols=64)

    run()  # the plan as computed
    plan = mod.launch_plan(70, 200, 130, 100 if kernel == "imc" else 64)
    bad = dict(plan)
    if field == "grid":
        bad["grid"] = tuple(v + dv for v, dv in zip(plan["grid"], delta))
    else:
        bad[field] = plan[field] + delta
    monkeypatch.setattr(mod, "launch_plan", lambda *a: bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        run()


def test_device_fidelity_paths_launch_their_kernels(dev):
    from repro_torch.core import (
        EncoderConfig, ImcSimConfig, MemhdConfig, MemhdModel,
    )
    from repro_torch.core import am as am_lib
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=60, test_per_class=10,
                      device=dev)
    enc = EncoderConfig(features=784, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=2,
                      kmeans_iters=3)
    m, _ = MemhdModel.create(0, enc, amc, device=dev).fit(1, ds.train_x,
                                                           ds.train_y)
    kernels.reset_launches()
    ops.reset_dispatch()
    assert torch.equal(m.deploy(target="imc").predict(ds.test_x),
                       m.predict(ds.test_x))
    sim = ImcSimConfig(adc_bits=6, noise_sigma=0.5, fault_p0=0.01,
                       drift_sigma=1.0, seed=7)
    dep = m.deploy(target="imc", sim=sim)
    q = m.encode_query(ds.test_x)
    want = ref.am_search_imc(q, dep.am_analog.T, tile_rows=128,
                             tile_cols=128, adc_bits=6, adc_clip=128.0,
                             offsets=dep.tile_offsets)[0]
    assert torch.equal(dep.predict(ds.test_x),
                       m.am_state["centroid_class"][want.long()])
    tuned, _ = m.fit(2, ds.train_x, ds.train_y, init_method="keep",
                     epochs=1, cell_bits=4, noise_sim=ImcSimConfig(
                         noise_sigma=0.5), use_kernel=True)
    mb = tuned.deploy(target="multibit", cell_bits=4)
    assert torch.equal(mb.predict(ds.test_x), am_lib.multibit_predict(
        mb.am_planes_t, mb.centroid_class, tuned.encode_query(ds.test_x),
        4))
    launches = kernels.launches()
    for name in ("am_search_imc", "am_search_multibit", "qail_update"):
        assert launches[name] > 0, name
    assert "torch-ref" not in str(ops.dispatch_breakdown())


def test_fidelity_wrappers_reject_bad_operands(dev):
    x = torch.ones((4, 16), device=dev)
    with pytest.raises(ValueError, match="offsets shape"):
        am_search_imc.am_search_imc(x, x.T, torch.zeros((2, 2), device=dev),
                                    tile_rows=8, tile_cols=4)
    with pytest.raises(ValueError, match="geometry"):
        am_search_imc.am_search_imc(x, x.T, tile_rows=0)
    planes = ref.pack_planes(torch.zeros((4, 16), dtype=torch.int32,
                                         device=dev), 3)
    with pytest.raises(ValueError, match="byte multiple"):
        am_search_multibit.am_search_multibit(x, planes, cell_bits=3,
                                              tile_rows=12)
    with pytest.raises(ValueError, match="planes"):
        am_search_multibit.am_search_multibit(x, planes, cell_bits=4)
    with pytest.raises(TypeError):
        binary_mvm.binary_mvm(x.double(), x.T.contiguous().double())
    with pytest.raises(TypeError):
        pack_bits.unpack_bits(x)



# The hierarchical kernels: D over ragged bytes and tail bits, G and C over
# 1, 2, 45, 448 and ragged counts (D, G or C).
HIER_D = (8, 100, 1000, 1024)
HIER_G = (1, 2, 45, 448)


def packed_rows(rng, shape, dev, dup=False):
    x = bipolar(rng, shape, dev)
    if dup:  # duplicated rows: forced ties
        x = x[torch.arange(shape[0], device=dev) % max(1, shape[0] // 2)]
    return ref.pack_rows(x)


@pytest.mark.parametrize("d", HIER_D)
@pytest.mark.parametrize("g", HIER_G)
def test_am_shortlist(dev, d, g):
    rng = np.random.default_rng([20, d, g])
    q = packed_rows(rng, (7, d), dev)
    for dup in (False, True):
        spt = packed_rows(rng, (g, d), dev, dup).T.contiguous()
        for s in sorted({1, min(3, g), g}):
            got = am_shortlist.am_shortlist(q, spt, n_dims=d, s=s)
            want = ref.am_shortlist(q, spt, d, s)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def test_am_shortlist_streams_a_large_g(dev):
    # Past the shared-memory budget the stream route's keys go through
    # global scratch (S = 600: its splits would not merge in a warp); a
    # short S splits G over the tile route.
    rng = np.random.default_rng(21)
    g = am_shortlist.SMEM_SLOTS + 77
    q = packed_rows(rng, (3, 100), dev)
    spt = packed_rows(rng, (g, 100), dev, dup=True).T.contiguous()
    for s, route in ((1, "tile"), (5, "tile"), (600, "stream")):
        am_shortlist.reset_routes()
        got = am_shortlist.am_shortlist(q, spt, n_dims=100, s=s)
        want = ref.am_shortlist(q, spt, 100, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert am_shortlist.route_counts()[route] == 1


SHORTLIST_G = (1, 2, 3, 45, 448, 1000, 1777)


@pytest.mark.parametrize("d", HIER_D)
@pytest.mark.parametrize("g", SHORTLIST_G)
def test_am_shortlist_every_split_and_route(dev, d, g):
    """Both routes and the tile route's splits, bit-exact: random and
    duplicated super-centroids (forced ties), S in {1, mid, G}, at a
    served batch, a ragged one of 16-row tiles and one whose plan splits
    G over fewer blocks; each launch counted on the route its plan names.
    The grids the plan makes for a 1-SM device (the fewest splits) and an
    unbounded one (the narrowest) give the same result."""
    rng = np.random.default_rng([31, d, g])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in (5, 37, 600):
        q = packed_rows(rng, (b, d), dev)
        for dup in (False, True):
            spt = packed_rows(rng, (g, d), dev, dup).T.contiguous()
            for s in sorted({1, max(1, g // 2), g}):
                want = ref.am_shortlist(q, spt, d, s)
                plan = am_shortlist.launch_plan(b, -(-d // 8), g, s, sms)
                am_shortlist.reset_routes()
                got = am_shortlist.am_shortlist(q, spt, n_dims=d, s=s)
                assert torch.equal(got[0], want[0]), (b, dup, s)
                assert torch.equal(got[1], want[1]), (b, dup, s)
                assert am_shortlist.route_counts() == {
                    r: int(r == plan["route"]) for r in am_shortlist.ROUTES}
                for n in (1, 1 << 30):
                    got = am_shortlist._launch(q, spt, d, s, n)
                    assert got[2] == am_shortlist.launch_plan(
                        b, -(-d // 8), g, s, n)["route"]
                    assert torch.equal(got[0], want[0]), (b, dup, s, n)
                    assert torch.equal(got[1], want[1]), (b, dup, s, n)


@pytest.mark.parametrize("d", [1100, 2048, 4100])
def test_am_shortlist_long_d_streams_through_the_ring(dev, d):
    """Past D = 1024 (more k slabs than ring stages) the tile route
    streams its slabs through the ring: bit-exact at the plan's split
    and at one (a 1-SM device's plan), ties forced."""
    rng = np.random.default_rng([40, d])
    q = packed_rows(rng, (37, d), dev)
    spt = packed_rows(rng, (448, d), dev, dup=True).T.contiguous()
    for s in (1, 8, 448):
        want = ref.am_shortlist(q, spt, d, s)
        for sms in (None, 1):
            got = am_shortlist._launch(q, spt, d, s, sms)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])


def test_am_shortlist_split_tickets_are_left_all_ones(dev):
    """The tile route's merge tickets start and end all ones, so launches
    of any split in a row (the plan's, the narrowest, another S's) need
    no memset."""
    rng = np.random.default_rng(32)
    q = packed_rows(rng, (70, 1024), dev)
    spt = packed_rows(rng, (448, 1024), dev, dup=True).T.contiguous()
    for s, sms in ((8, None), (16, None), (3, 1 << 30), (8, 1 << 30)):
        got = am_shortlist._launch(q, spt, 1024, s, sms)
        want = ref.am_shortlist(q, spt, 1024, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert bool((am_shortlist._TICKETS[(q.device, stream)] == 255).all())


@pytest.mark.parametrize("field,delta", [("splits", 1), ("cols", 16),
                                         ("kpl", 2), ("grid", (1, 0)),
                                         ("smem", 16), ("sms", -(1 << 20)),
                                         ("scratch_bytes", 8)])
def test_am_shortlist_launcher_refuses_another_plan(dev, monkeypatch, field,
                                                    delta):
    """The launcher takes the wrapper's launch_plan and refuses one that
    is not its own (or made for fewer than one SM); the refused launch
    drops the stream's tickets and the next launch equals the plain
    version."""
    rng = np.random.default_rng(33)
    q = packed_rows(rng, (40, 1024), dev)
    spt = packed_rows(rng, (448, 1024), dev).T.contiguous()
    real = am_shortlist.launch_plan

    def bad(*a):
        plan = dict(real(*a))
        if field == "grid":
            plan["grid"] = tuple(v + dv for v, dv in zip(plan["grid"],
                                                         delta))
        else:
            plan[field] += delta
        return plan

    monkeypatch.setattr(am_shortlist, "launch_plan", bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        am_shortlist.am_shortlist(q, spt, n_dims=1024, s=8)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert (q.device, stream) not in am_shortlist._TICKETS
    monkeypatch.undo()
    got = am_shortlist.am_shortlist(q, spt, n_dims=1024, s=8)
    want = ref.am_shortlist(q, spt, 1024, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_use_kernel_none_runs_the_kernel(dev):
    """A reference-style ops call (use_kernel=None, block_b=None) runs the
    cuda tier on a CUDA tensor."""
    rng = np.random.default_rng(34)
    q = packed_rows(rng, (6, 1024), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 900, 1024, 7, dev)
    spt = packed_rows(rng, (7, 1024), dev).T.contiguous()
    ops.reset_dispatch()
    kernels.reset_launches()
    short, _ = ops.am_shortlist(q, spt, n_dims=1024, s=3, use_kernel=None,
                                block_b=None)
    ops.am_search_sparse(q, slab, ids, short, ts, tc, n_dims=1024, k=2,
                         max_tiles=mt, use_kernel=None, block_b=None)
    tiers = ops.dispatch_breakdown()
    assert tiers["am_shortlist"] == {"cuda": 1}
    assert tiers["am_search_sparse"] == {"cuda": 1}
    assert kernels.launches()["am_shortlist"] == 1
    assert kernels.launches()["am_search_sparse"] == 1


def layout(rng, c, d, g, dev, dup=True):
    from repro_torch.deploy import hierarchical as hier
    am_t = packed_rows(rng, (c, d), dev, dup).T.contiguous()
    lay = hier.build_layout(am_t.cpu().numpy(), rng.integers(0, g, size=c),
                            g)
    return am_t, [torch.as_tensor(a, device=dev) for a in (
        lay.slab, lay.col_ids, lay.tile_start, lay.tile_count)], lay.max_tiles


@pytest.mark.parametrize("d", HIER_D)
@pytest.mark.parametrize("c,g", [(1, 1), (2, 2), (300, 45), (1000, 448),
                                 (257, 2), (9, 3)])
def test_am_search_sparse(dev, d, c, g):
    rng = np.random.default_rng([22, d, c, g])
    q = packed_rows(rng, (5, d), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, c, d, g, dev)
    for s in sorted({1, min(3, g), g}):
        short = torch.as_tensor(np.stack([rng.permutation(g)[:s]
                                          for _ in range(5)]),
                                dtype=torch.int32, device=dev)
        for k in (1, 5, c + 2):
            got = am_search_sparse.am_search_sparse(
                q, slab, ids, short, ts, tc, n_dims=d, k=k, max_tiles=mt)
            want = am_search_sparse.am_search_sparse_plain(
                q, slab, ids, short, ts, tc, n_dims=d, k=k, max_tiles=mt)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            # The fused gather equals gather-then-gathered-kernel.
            tiles = am_search_sparse.expand_shortlist_tiles(
                short, ts, tc, max_tiles=mt, null_tile=slab.shape[1] // 128
                - 1)
            gat, gid = am_search_sparse.gather_shortlist(slab, ids, tiles)
            got2 = am_search_sparse.am_search_sparse_gathered(
                q, gat, gid.contiguous(), n_dims=d, k=k)
            assert torch.equal(got2[0], want[0]) and torch.equal(got2[1],
                                                                 want[1])


def test_sparse_exact_configuration_equals_the_flat_scan(dev):
    rng = np.random.default_rng(23)
    q = packed_rows(rng, (64, 1024), dev)
    am_t, (slab, ids, ts, tc), mt = layout(rng, 512, 1024, 23, dev)
    short = torch.arange(23, dtype=torch.int32, device=dev).repeat(64, 1)
    idx, sim = am_search_sparse.am_search_sparse(
        q, slab, ids, short, ts, tc, n_dims=1024, k=1, max_tiles=mt)
    f_idx, f_sim = asp.am_search_packed(q, am_t, n_dims=1024)
    assert torch.equal(idx[:, 0], f_idx) and torch.equal(sim[:, 0], f_sim)
    # The global-scratch path (S * max_tiles * 128 past the budget).
    from repro_torch.kernels.am_shortlist import SMEM_SLOTS
    reps = -(-SMEM_SLOTS // (23 * mt * 128)) + 1
    wide = short.repeat(1, reps)
    got = am_search_sparse.am_search_sparse(
        q, slab, ids, wide, ts, tc, n_dims=1024, k=7, max_tiles=mt)
    want = am_search_sparse.am_search_sparse_plain(
        q, slab, ids, wide, ts, tc, n_dims=1024, k=7, max_tiles=mt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def sparse_three_ways(q, slab, ids, short, ts, tc, d, k, mt):
    """Fused kernel, gathered kernel and the plain version, bit-equal."""
    want = am_search_sparse.am_search_sparse_plain(
        q, slab, ids, short, ts, tc, n_dims=d, k=k, max_tiles=mt)
    got = am_search_sparse.am_search_sparse(
        q, slab, ids, short, ts, tc, n_dims=d, k=k, max_tiles=mt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tiles = am_search_sparse.expand_shortlist_tiles(
        short, ts, tc, max_tiles=mt, null_tile=slab.shape[1] // 128 - 1)
    gat, gid = am_search_sparse.gather_shortlist(slab, ids, tiles)
    got2 = am_search_sparse.am_search_sparse_gathered(
        q, gat, gid.contiguous(), n_dims=d, k=k)
    assert torch.equal(got2[0], want[0]) and torch.equal(got2[1], want[1])
    return want


@pytest.mark.parametrize("d", [8, 36, 100, 1000, 1100, 2048])
def test_am_search_sparse_odd_and_long_tiles(dev, d):
    """Dp not a multiple of 4 (1, 5, 13, 125 bytes) and Dp past the
    128-row ring stage (138: a partial second chunk; 256: two)."""
    rng = np.random.default_rng([24, d])
    q = packed_rows(rng, (9, d), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 700, d, 6, dev)
    short = torch.as_tensor(np.stack([rng.permutation(6)[:3]
                                      for _ in range(9)]),
                            dtype=torch.int32, device=dev)
    for k in (1, 4):
        sparse_three_ways(q, slab, ids, short, ts, tc, d, k, mt)


def test_am_search_sparse_duplicate_and_out_of_range_entries(dev):
    """A cluster listed twice returns its columns twice (ties by slot);
    entries outside [0, G) read as the null tile; an all-null shortlist
    and k past the valid candidates give exhausted slots."""
    rng = np.random.default_rng(25)
    d, g = 1024, 7
    q = packed_rows(rng, (6, d), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 900, d, g, dev)
    cases = {"dup": [[2, 2, 5], [0, 3, 0], [6, 6, 6], [1, 4, 1],
                     [5, 2, 5], [3, 3, 3]],
             "out": [[-1, 2, g], [g + 3, 0, -7], [1, -1, 1], [g, g, 4],
                     [0, 1, 2], [-2, 6, g + 100]],
             "null": [[-1, g, -5]] * 6}
    for name, rows in cases.items():
        short = torch.tensor(rows, dtype=torch.int32, device=dev)
        for k in (1, 5, 3 * mt * 128 + 9):
            want = sparse_three_ways(q, slab, ids, short, ts, tc, d, k, mt)
            if name == "null":
                assert (want[0] == -1).all() and (want[1] == ref.NEG).all()
            if name == "dup" and k == 5:  # cluster 6 listed three times:
                best = want[0][2, :3]     # its best column three times
                assert (best == best[0]).all() and best[0] >= 0


def test_am_search_sparse_gathered_scratch_path(dev):
    """Past the shared-memory budget both entries stream their keys
    through the global scratch."""
    rng = np.random.default_rng(26)
    d = 100
    q = packed_rows(rng, (3, d), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 300, d, 4, dev)
    reps = -(-am_shortlist.SMEM_SLOTS // (4 * mt * 128)) + 1
    short = torch.arange(4, dtype=torch.int32, device=dev).repeat(3, reps)
    assert not am_search_sparse.launch_plan(
        3, 13, short.shape[1] * mt * 128)["keys_in_smem"]
    for k in (1, 9):
        sparse_three_ways(q, slab, ids, short, ts, tc, d, k, mt)


def test_am_shortlist_at_the_huge_label_shape(dev):
    """am_shortlist bit-exact at the huge-label shape, B 256, G 448,
    D 1024, S 8 and 16."""
    rng = np.random.default_rng(27)
    q = packed_rows(rng, (256, 1024), dev)
    spt = packed_rows(rng, (448, 1024), dev, dup=True).T.contiguous()
    for s in (8, 16):
        got = am_shortlist.am_shortlist(q, spt, n_dims=1024, s=s)
        want = ref.am_shortlist(q, spt, 1024, s)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_am_search_sparse_phase_clocks(dev):
    """The measurement launch records each block's start, end of scoring
    and end, in order, and counts no launch."""
    rng = np.random.default_rng(28)
    q = packed_rows(rng, (16, 1024), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 2000, 1024, 20, dev)
    short = torch.as_tensor(np.stack([rng.permutation(20)[:8]
                                      for _ in range(16)]),
                            dtype=torch.int32, device=dev)
    n = am_search_sparse.am_search_sparse.launches
    clk = am_search_sparse.phase_clocks(q, slab, ids, short, ts, tc,
                                        n_dims=1024, k=1, max_tiles=mt)
    assert am_search_sparse.am_search_sparse.launches == n
    assert clk.shape == (16, 3)
    assert (clk[:, 0] > 0).all() and (clk[:, 1] >= clk[:, 0]).all()
    assert (clk[:, 2] >= clk[:, 1]).all()


UNPACK_FIELDS = [("rows", 16), ("cols", 64), ("grid", (1, 0)),
                 ("grid", (0, 1)), ("smem", 8), ("scratch_bytes", 8),
                 ("sms", 1)]


@pytest.mark.parametrize("mode", asp.MODES)
@pytest.mark.parametrize("field,delta", UNPACK_FIELDS)
def test_am_search_packed_launcher_refuses_another_plan(dev, monkeypatch,
                                                        mode, field, delta):
    """The launcher takes the wrapper's launch_plan and refuses one that
    is not its own grid, tiles, shared memory, scratch or SM count, in
    both modes (popcount mode's columns and grid follow its k split and
    the SM count); the refused launch drops the stream's fold scratch, and
    the next launch equals the plain version."""
    rng = np.random.default_rng(29)
    q = ref.pack_rows(bipolar(rng, (40, 200), dev))
    am_t = ref.pack_rows(bipolar(rng, (300, 200), dev)).T.contiguous()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = asp.launch_plan(40, 25, 300, 8, mode, sms)
    asp.am_search_packed(q, am_t, n_dims=200, mode=mode)  # as computed
    bad = dict(plan)
    if field == "grid":
        bad["grid"] = tuple(v + dv for v, dv in zip(plan["grid"], delta))
    else:
        bad[field] = plan[field] + delta
    monkeypatch.setattr(asp, "launch_plan", lambda *a: bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        asp.am_search_packed(q, am_t, n_dims=200, mode=mode)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    assert (q.device, stream) not in asp._SCRATCH
    monkeypatch.undo()
    got = asp.am_search_packed(q, am_t, n_dims=200, mode=mode)
    want = ref.am_search_packed(q, am_t, 200)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("field,delta", [("grid", 1), ("stages", 1),
                                         ("chunk_rows", -4), ("smem", 16),
                                         ("keys_in_smem", None)])
def test_am_search_sparse_launcher_refuses_another_plan(
        dev, monkeypatch, gathered, field, delta):
    """Both entries take the wrapper's launch_plan and refuse one that is
    not their own (keys_in_smem flipped: a scratch where the launcher
    keeps the keys in shared memory)."""
    rng = np.random.default_rng(30)
    q = packed_rows(rng, (4, 100), dev)
    _, (slab, ids, ts, tc), mt = layout(rng, 300, 100, 3, dev)
    short = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    tiles = am_search_sparse.expand_shortlist_tiles(
        short, ts, tc, max_tiles=mt, null_tile=slab.shape[1] // 128 - 1)
    gat, gid = am_search_sparse.gather_shortlist(slab, ids, tiles)

    def run():
        if gathered:
            return am_search_sparse.am_search_sparse_gathered(
                q, gat, gid.contiguous(), n_dims=100, k=2)
        return am_search_sparse.am_search_sparse(
            q, slab, ids, short, ts, tc, n_dims=100, k=2, max_tiles=mt)

    run()  # the plan as computed
    real = am_search_sparse.launch_plan

    def bad(*a):
        plan = real(*a)
        if field == "keys_in_smem":
            return {**plan, field: not plan[field]}
        return {**plan, field: plan[field] + delta}

    monkeypatch.setattr(am_search_sparse, "launch_plan", bad)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        run()


def test_hierarchical_path_launches_its_kernels(dev):
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=60, test_per_class=10,
                      device=dev)
    enc = EncoderConfig(features=784, dim=128)
    amc = MemhdConfig(dim=128, columns=128, classes=10, epochs=2,
                      kmeans_iters=3)
    m, _ = MemhdModel.create(0, enc, amc, device=dev).fit(1, ds.train_x,
                                                           ds.train_y)
    flat = m.deploy(target="packed")
    kernels.reset_launches()
    ops.reset_dispatch()
    hier = m.deploy(target="hierarchical")
    assert torch.equal(hier.predict(ds.test_x), flat.predict(ds.test_x))
    cls, idx, sims = hier.predict_topk(ds.test_x, 5)
    q = ref.pack_rows(m.encode_query(ds.test_x))
    w_idx, w_sims = ref.am_search_topk(q, flat.am_packed_t, 128, 5)
    assert torch.equal(idx, w_idx) and torch.equal(sims, w_sims)
    small = m.deploy(target="hierarchical", shortlist=2)
    small.predict_topk(ds.test_x, 3)
    launches = kernels.launches()
    for name in ("am_shortlist", "am_search_sparse"):
        assert launches[name] > 0, name
    assert "torch-ref" not in str(ops.dispatch_breakdown())


def test_hierarchical_wrappers_reject_bad_operands(dev):
    q = torch.zeros((2, 16), dtype=torch.uint8, device=dev)
    spt = torch.zeros((16, 5), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shortlist"):
        am_shortlist.am_shortlist(q, spt, n_dims=128, s=6)
    with pytest.raises(ValueError, match="different devices"):
        am_shortlist.am_shortlist(q, spt.cpu(), n_dims=128, s=1)
    with pytest.raises(ValueError, match="contiguous"):
        am_shortlist.am_shortlist(q, spt.T.contiguous().T, n_dims=128, s=1)
    slab = torch.zeros((16, 256), dtype=torch.uint8, device=dev)
    ids = torch.full((256,), -1, dtype=torch.int32, device=dev)
    ts = torch.zeros(1, dtype=torch.int32, device=dev)
    short = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):  # tile_count must be int32
        am_search_sparse.am_search_sparse(q, slab, ids, short, ts, ts.long(),
                                          n_dims=128, k=1, max_tiles=1)
    with pytest.raises(ValueError, match="k=0"):
        am_search_sparse.am_search_sparse(q, slab, ids, short, ts, ts,
                                          n_dims=128, k=0, max_tiles=1)
    idx, sim = am_search_sparse.am_search_sparse(
        q, slab, ids, short, ts, ts, n_dims=128, k=3, max_tiles=1)
    assert (idx == -1).all() and (sim == ref.NEG).all()  # nothing valid


# -- the LM kernels -----------------------------------------------------------

def bf16_ulp(x):
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("h,kv,dh", [(25, 5, 64), (4, 4, 128), (6, 1, 32),
                                     (4, 2, 20)])
@pytest.mark.parametrize("s", [1, 127, 1600])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode(dev, h, kv, dh, s, dtype):
    """Within 3e-5 + 3e-5|x| of the plain version in float32, one bf16 ulp
    + 3e-5 in bfloat16; a row with cache_len 0 yields 0."""
    rng = np.random.default_rng([20, h, kv, dh, s])
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(dt)
               for shape in ((3, h, dh), (3, s, kv, dh), (3, s, kv, dh)))
    lens = torch.tensor([s, 0, min(s, s // 2 + 1)], dtype=torch.int32,
                        device=dev)
    got = flash_decode.flash_decode(q, k, v, lens)
    want = ref.flash_decode(q, k, v, lens)
    err = (got.float() - want.float()).abs()
    tol = (3e-5 + 3e-5 * want.float().abs() if dt == torch.float32
           else bf16_ulp(want) + 3e-5)
    assert (err <= tol).all(), err.max().item()
    assert not got[1].any()


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (a view with storage_offset 1)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16
    return view


def flash_decode_case(rng, b, s, h, kv, dh, dt, dev):
    q, k, v = (torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev).to(dt)
               for shape in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    lens = torch.tensor([s, 0, min(s, 1), min(s, s // 2 + 1)][:b],
                        dtype=torch.int32, device=dev)
    return q, k, v, lens


def assert_flash_decode(got, want, dt):
    err = (got.float() - want.float()).abs()
    tol = (3e-5 + 3e-5 * want.float().abs() if dt == torch.float32
           else bf16_ulp(want) + 3e-5)
    assert (err <= tol).all(), err.max().item()


@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 320, 4097])
@pytest.mark.parametrize("dh", [20, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_tile_and_stage_edges(dev, s, dh, dtype):
    """S across the 64-key tile and the 3-stage ring's edges, Dh padded
    (20) and at every padded width, G = H / KV in {1, 5, 6, 16, 32} (two
    blocks of 16 heads at 32); ragged lens with 0 and 1."""
    dt = getattr(torch, dtype)
    for g in (1, 5, 6, 16, 32):
        rng = np.random.default_rng([22, s, dh, g])
        q, k, v, lens = flash_decode_case(rng, 4, s, 2 * g, 2, dh, dt, dev)
        got = flash_decode.flash_decode(q, k, v, lens)
        assert_flash_decode(got, ref.flash_decode(q, k, v, lens), dt)
        assert not got[1].any()


@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 64, 65, 320, 4097])
@pytest.mark.parametrize("dh", [20, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_softcap_tile_and_stage_edges(dev, s, dh, dtype):
    """The softcap instances of both routes over the same grid, at a cap
    that bites (2.0 on scores of a few units), against the plain version
    with the same cap; the cap changes the result."""
    dt = getattr(torch, dtype)
    for g in (1, 5, 6, 16, 32):
        rng = np.random.default_rng([24, s, dh, g])
        q, k, v, lens = flash_decode_case(rng, 4, s, 2 * g, 2, dh, dt, dev)
        q = q * 3
        got = flash_decode.flash_decode(q, k, v, lens, softcap=2.0)
        assert_flash_decode(got, ref.flash_decode(q, k, v, lens, 2.0), dt)
        assert not got[1].any()
        if s > 16:
            assert not torch.equal(got, flash_decode.flash_decode(q, k, v,
                                                                  lens))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_softcap_none_launches_the_uncapped_kernel(dev, dtype):
    """softcap=None runs the pass-1 instance without the cap (CAP =
    false) on the plan it always had; a cap runs the CAP = true instance
    of the same route on the same plan (the plan takes no cap)."""
    from torch.profiler import ProfilerActivity, profile
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(25)
    q, k, v, lens = flash_decode_case(rng, 4, 1000, 10, 2, 64, dt, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = flash_decode.split_plan(4, 2, 1000, sms, dtype=dt, groups=5,
                                   dh=64)
    names = {}
    for cap in (None, 30.0):
        # Once outside the trace: a first call in the process builds the
        # library and loads the kernels, and the trace then missed them.
        flash_decode.flash_decode(q, k, v, lens, softcap=cap)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_decode.flash_decode(q, k, v, lens, softcap=cap)
            torch.cuda.synchronize()
        names[cap] = sorted({e.key for e in prof.key_averages()
                             if "flash_decode_" in e.key
                             and "merge" not in e.key})
    kern = ("flash_decode_simt<true, " if dt == torch.float32
            else "flash_decode_mma<64, true, ")
    assert len(names[None]) == 1 and kern + "false>" in names[None][0]
    assert len(names[30.0]) == 1 and kern + "true>" in names[30.0][0]
    assert plan == flash_decode.split_plan(4, 2, 1000, sms, dtype=dt,
                                           groups=5, dh=64)
    with pytest.raises(ValueError, match="positive"):
        flash_decode.flash_decode(q, k, v, lens, softcap=0.0)


@pytest.mark.parametrize("dh", [20, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_misaligned_cache_views(dev, dh, dtype):
    """K / V views that start off a 16-byte boundary take the kernel's
    scalar-load variant and give the same result."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng([23, dh])
    q, k, v, lens = flash_decode_case(rng, 4, 300, 10, 2, dh, dt, dev)
    km, vm = misaligned(k), misaligned(v)
    got = flash_decode.flash_decode(q, km, vm, lens)
    want = ref.flash_decode(q, k, v, lens)
    assert_flash_decode(got, want, dt)
    assert torch.equal(got, flash_decode.flash_decode(q, k, v, lens))


@pytest.mark.parametrize("k", [9, 100, 617, 784])
@pytest.mark.parametrize("tile", range(len(binary_mvm.SGEMM_TILES)))
def test_binary_mvm_and_encode_pack_every_tile(dev, k, tile):
    """Every block tile of the shared mainloop at B = 1 and at a ragged
    B: dyadic features bit-exact (binary_mvm against the plain product,
    encode_pack against the plain packing); float features within
    2^-20 * sum|x*w|."""
    for b, n in ((1, 1024), (131, 200)):
        rng = np.random.default_rng([24, k, b, n])
        w = bipolar(rng, (k, n), dev)
        xd = feats(rng, (b, k), dev, True)
        assert torch.equal(binary_mvm.binary_mvm_tiled(xd, w, tile), xd @ w)
        assert torch.equal(binary_mvm.binary_mvm(xd, w), xd @ w)
        assert torch.equal(encode_fused.encode_pack(xd, w),
                           ref.encode_pack(xd, w))
        xf = feats(rng, (b, k), dev, False)
        err = (binary_mvm.binary_mvm_tiled(xf, w, tile) - xf @ w).abs()
        assert (err <= 2.0 ** -20 * (xf.abs() @ w.abs())).all()


@pytest.mark.parametrize("k", [9, 100, 784])
def test_binary_mvm_and_encode_pack_misaligned_views(dev, k):
    """Operands that start off a 16-byte boundary (storage_offset 1) take
    the scalar-copy variant and agree bit for bit with aligned ones."""
    rng = np.random.default_rng([25, k])
    w = bipolar(rng, (k, 256), dev)
    x = feats(rng, (37, k), dev, False)
    want = binary_mvm.binary_mvm(x, w)
    for xv, wv in ((misaligned(x), w), (x, misaligned(w)),
                   (misaligned(x), misaligned(w))):
        assert torch.equal(binary_mvm.binary_mvm(xv, wv), want)
        assert torch.equal(encode_fused.encode_pack(xv, wv),
                           encode_fused.encode_pack(x, w))


@pytest.mark.parametrize("h,n,p", [(50, 16, 64), (24, 128, 64), (3, 32, 8),
                                   (2, 100, 128)])
@pytest.mark.parametrize("q", [1, 20, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk(dev, h, n, p, q, dtype):
    """Within 1e-4 + 1e-4|x| of the plain version (plus one bf16 ulp on a
    bfloat16 y), from a chunk sliced out of a longer sequence."""
    rng = np.random.default_rng([21, h, n, p, q])
    dt_ = getattr(torch, dtype)

    def t(shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               * scale, device=dev)
    x, bm, cm = (t((2, 2 * q, h, d)).to(dt_) for d in (p, n, n))
    dt = t((2, 2 * q, h)).abs() * 0.1
    da = -dt * t((2, 2 * q, h)).abs()
    s0 = t((2, h, n, p))
    args = [a[:, q:] for a in (x, bm, cm, dt, da)] + [s0]
    y, s_new = ssd_chunk.ssd_chunk(*args)
    wy, ws = ref.ssd_chunk(*args)
    tol = 1e-4 + 1e-4 * wy.float().abs()
    if dt_ == torch.bfloat16:
        tol = tol + bf16_ulp(wy)
    assert y.dtype == dt_ and ((y.float() - wy.float()).abs() <= tol).all()
    assert ((s_new - ws).abs() <= 1e-4 + 1e-4 * ws.abs()).all()


@pytest.mark.parametrize("q", [1, 63, 64, 65, 129, 256, 257])
@pytest.mark.parametrize("n", [1, 16, 128])
@pytest.mark.parametrize("p", [20, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_grid(dev, q, n, p, dtype):
    """Every row tile, ragged tails, both dtypes, B of 1, 2 and 8 and
    strided batch rows, at the unchanged tolerance of test_ssd_chunk."""
    b = (1, 2, 8)[(q + n + p) % 3]
    rng = np.random.default_rng([22, q, n, p, b])
    dt_ = getattr(torch, dtype)
    h = 3

    def t(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, bm, cm = (t((b, q + 5, h, d)).to(dt_) for d in (p, n, n))
    dt = t((b, q + 5, h)).abs() * 0.1
    da = -dt * t((b, q + 5, h)).abs()
    s0 = t((b, h, n, p))
    args = [a[:, 5:] for a in (x, bm, cm, dt, da)] + [s0]
    y, s_new = ssd_chunk.ssd_chunk(*args)
    wy, ws = ref.ssd_chunk(*args)
    tol = 1e-4 + 1e-4 * wy.float().abs()
    if dt_ == torch.bfloat16:
        tol = tol + bf16_ulp(wy)
    assert y.dtype == dt_ and ((y.float() - wy.float()).abs() <= tol).all()
    assert ((s_new - ws).abs() <= 1e-4 + 1e-4 * ws.abs()).all()


@pytest.mark.parametrize("field,delta", [("y_blocks", 1),
                                         ("state_blocks", -1),
                                         ("col_tiles", 2), ("smem", 16)])
def test_ssd_chunk_launcher_refuses_another_plan(dev, monkeypatch, field,
                                                 delta):
    """The launcher takes the wrapper's launch_plan and refuses one that
    is not the kernel's own grid, instance or shared memory."""
    b, q, h, n, p = 2, 100, 3, 16, 64
    x, bm, cm = (torch.ones((b, q, h, d), device=dev) for d in (p, n, n))
    dt = torch.full((b, q, h), 0.1, device=dev)
    s0 = torch.zeros((b, h, n, p), device=dev)
    plan = ssd_chunk.launch_plan(b, q, h, n, p, torch.float32)
    ssd_chunk.ssd_chunk(x, bm, cm, dt, -dt, s0)  # the plan as computed
    monkeypatch.setattr(ssd_chunk, "launch_plan",
                        lambda *a: {**plan, field: plan[field] + delta})
    with pytest.raises(RuntimeError, match="cudaError_t"):
        ssd_chunk.ssd_chunk(x, bm, cm, dt, -dt, s0)


def test_ssd_chunk_whole_chunk_equals_two_halves(dev):
    """Two chained chunks of 128 == one chunk of 256, within tolerance."""
    rng = np.random.default_rng(23)
    h, n, p = 50, 16, 64

    def t(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, bm, cm = (t((2, 256, h, d)) for d in (p, n, n))
    dt = t((2, 256, h)).abs() * 0.1
    da = -dt * t((2, 256, h)).abs()
    s0 = t((2, h, n, p))
    wy, ws = ssd_chunk.ssd_chunk(x, bm, cm, dt, da, s0)
    y1, s1 = ssd_chunk.ssd_chunk(x[:, :128], bm[:, :128], cm[:, :128],
                                 dt[:, :128], da[:, :128], s0)
    y2, s2 = ssd_chunk.ssd_chunk(x[:, 128:], bm[:, 128:], cm[:, 128:],
                                 dt[:, 128:], da[:, 128:], s1)
    y = torch.cat([y1, y2], 1)
    assert ((y - wy).abs() <= 1e-4 + 1e-4 * wy.abs()).all()
    assert ((s2 - ws).abs() <= 1e-4 + 1e-4 * ws.abs()).all()


def test_lm_path_launches_its_kernels(dev):
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("hymba-1.5b")
    params = T.init_params(generator(0, dev), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=dev,
                         generator=generator(1, dev), dtype=torch.int32)
    kernels.reset_launches()
    ops.reset_dispatch()
    with torch.inference_mode():
        logits, _ = T.forward(params, cfg, {"tokens": toks})
        plain, _ = T.forward(params, cfg, {"tokens": toks}, use_kernel=False)
    out = serve.generate(cfg, params, toks[:, :8], 4)
    launches, tiers = kernels.launches(), ops.dispatch_breakdown()
    assert launches["ssd_chunk"] == cfg.n_layers * 2
    assert launches["flash_decode"] == cfg.n_layers * 11
    assert tiers["ssd_chunk"] == {"cuda": 6, "torch-ref": 6}
    assert tiers["flash_decode"] == {"cuda": 33}
    assert (logits - plain).abs().max() <= 1e-4 * plain.abs().max()
    assert out.shape == (2, 12) and out.device.type == "cuda"


def ssd_operands(rng, h, n, p, q, dev):
    """The hymba / mamba2 chunk operands of test_ssd_chunk, float32."""
    def t(shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)
    x, bm, cm = (t((2, q, h, d)) for d in (p, n, n))
    dt = t((2, q, h)).abs() * 0.1
    return [x, bm, cm, dt, -dt * t((2, q, h)).abs(), t((2, h, n, p))]


@pytest.mark.parametrize("h,n,p", [(50, 16, 64), (24, 128, 64)])
def test_ssd_chunk_function_vjp(dev, h, n, p):
    """``SsdChunk`` at hymba's and mamba2's chunk shapes (Q 256): its VJP
    is the plain version's (the same backward on the same saved inputs:
    equal within 1e-6 relative), no input is left without a gradient,
    the forward is one counted kernel launch, and the VJP agrees with a
    central difference of the kernel's own forward along a random
    direction (gradcheck-style, in float32: step 1e-2, within 2e-2
    relative of the directional derivative)."""
    rng = np.random.default_rng([41, h, n, p])
    ins = ssd_operands(rng, h, n, p, 256, dev)
    gy = torch.as_tensor(rng.normal(size=ins[0].shape).astype(np.float32),
                         device=dev)
    gs = torch.as_tensor(rng.normal(size=ins[5].shape).astype(np.float32),
                         device=dev)

    def vjp(fn):
        leaves = [a.clone().requires_grad_() for a in ins]
        y, s_new = fn(*leaves)
        torch.autograd.backward((y, s_new), (gy, gs))
        return [a.grad for a in leaves]

    before = ssd_chunk.ssd_chunk.launches
    got = vjp(ssd_chunk.SsdChunk.apply)
    assert ssd_chunk.ssd_chunk.launches == before + 1
    want = vjp(ref.ssd_chunk)
    for g, w in zip(got, want):
        assert g is not None and bool(torch.isfinite(g).all())
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    direction = [torch.as_tensor(rng.normal(size=a.shape).astype(
        np.float32), device=dev) * a.abs().mean() for a in ins]
    direction[3] = direction[3].abs() * 0.1  # keep dt >= 0, da <= 0
    direction[4] = -direction[4].abs() * 0.1

    def objective(eps):
        y, s_new = ssd_chunk.ssd_chunk(*[a + eps * d for a, d in
                                         zip(ins, direction)])
        return float((y.double() * gy).sum() + (s_new.double() * gs).sum())

    eps = 1e-2
    numeric = (objective(eps) - objective(-eps)) / (2 * eps)
    analytic = float(sum((g.double() * d).sum()
                         for g, d in zip(got, direction)))
    assert abs(numeric - analytic) <= 2e-2 * abs(analytic), (numeric,
                                                             analytic)


def test_lm_train_step_runs_through_the_kernel(dev):
    """mamba2-130m's smoke config on the card: the loss and its gradients
    launch ``ssd_chunk`` once per layer and chunk (2 x 2), the gradients
    equal the plain route's within 1e-4 x max|leaf| (the kernel's stated
    1e-4 + 1e-4|x| forward tolerance), and a train step moves the params
    and keeps them finite."""
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import (AdamWConfig, ScheduleConfig,
                                   adamw_init, make_schedule)
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_smoke_config("mamba2-130m")
    params = T.init_params(generator(0, dev), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=dev,
                         generator=generator(1, dev), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    kernels.reset_launches()
    loss, _, grads = steps.loss_and_grads(params, cfg, batch)
    assert kernels.launches()["ssd_chunk"] == cfg.n_layers * 2
    loss_p, _, plain = steps.loss_and_grads(params, cfg, batch,
                                            use_kernel=False)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    for g, w in zip(tree_leaves(grads), tree_leaves(plain)):
        assert (g - w).abs().max() <= 1e-4 * w.abs().max()
    step = steps.make_train_step(cfg, AdamWConfig(), make_schedule(
        ScheduleConfig(warmup_steps=0, total_steps=10)))
    opt = adamw_init(params, AdamWConfig())
    # Step 1: the schedule's multiplier is 0 at step 0 (as the
    # reference's).
    new, _, metrics = step(params, opt, batch, 1)
    assert torch.isfinite(torch.as_tensor(float(metrics["loss"])))
    assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(new))
    assert not torch.equal(new["embed"], params["embed"])


MIXED = dict(param_dtype="float32", activation_dtype="bfloat16")


def test_lm_mixed_precision_runs_through_the_kernel(dev):
    """mamba2-130m's smoke config with float32 params and bfloat16
    activations on the card: the forward's logits are bfloat16 and its SSD
    chunks launch ``ssd_chunk`` (its operands float32); the logits and each
    gradient leaf (float32) on the kernel route within the bf16 yardstick
    of the plain route (the plain route's mixed run against its
    float32-activation run); a train step at lr > 0 keeps the params
    float32 and the moments fp32 and moves every leaf."""
    import dataclasses
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import (AdamWConfig, ScheduleConfig,
                                   adamw_init, make_schedule)
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_smoke_config("mamba2-130m", **MIXED)
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32")
    params = T.init_params(generator(0, dev), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 65), device=dev,
                         generator=generator(1, dev), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    kernels.reset_launches()
    with torch.no_grad():
        lk, _ = T.forward(params, cfg, batch)
    assert kernels.launches()["ssd_chunk"] == cfg.n_layers * 2
    with torch.no_grad():
        lp, _ = T.forward(params, cfg, batch, use_kernel=False)
        l32, _ = T.forward(params, cfg32, batch, use_kernel=False)
    assert lk.dtype == torch.bfloat16
    assert (lk.float() - lp.float()).abs().max() <= (
        lp.float() - l32).abs().max()
    grads = [tree_leaves(steps.loss_and_grads(params, c, batch,
                                              use_kernel=k)[2])
             for c, k in ((cfg, True), (cfg, False), (cfg32, False))]
    for g, w, w32 in zip(*grads):
        assert g.dtype == torch.float32
        assert (g - w).abs().max() <= (w - w32).abs().max()
    step = steps.make_train_step(cfg, AdamWConfig(), make_schedule(
        ScheduleConfig(warmup_steps=2, total_steps=10)))
    new, opt, metrics = step(params, adamw_init(params, AdamWConfig()),
                             batch, 3)
    assert torch.isfinite(torch.as_tensor(float(metrics["loss"])))
    for a, p0 in zip(tree_leaves(new), tree_leaves(params)):
        assert a.dtype == torch.float32 and not torch.equal(a, p0)
    assert {m.dtype for m in tree_leaves(opt["m"]) + tree_leaves(opt["v"])
            } == {torch.float32}


def test_lm_mixed_precision_decode_on_the_card(dev):
    """Mixed decode on the card: the SSM caches bfloat16 at init, then the
    conv window float32 and the state bfloat16 after every step (the
    reference's dtypes); each step's logits equal the CPU's plain decode
    within the bf16 yardstick; ``generate`` runs."""
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_map
    cfg = get_smoke_config("mamba2-130m", **MIXED)
    cfg32 = get_smoke_config("mamba2-130m")
    params = T.init_params(generator(0, "cpu"), cfg, device="cpu")
    on_dev = tree_map(lambda x: x.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=generator(1, "cpu"), dtype=torch.int32)
    caches = {k: T.init_cache(c, 2, 12, device=d) for k, (c, d) in
              {"card": (cfg, dev), "cpu": (cfg, "cpu"),
               "f32": (cfg32, "cpu")}.items()}

    def dtypes(c):
        return {(layer["ssm"]["conv"].dtype, layer["ssm"]["state"].dtype)
                for g in c for layer in g}

    assert dtypes(caches["card"]) == {(torch.bfloat16, torch.bfloat16)}
    with torch.inference_mode():
        for t in range(12):
            tok = toks[:, t:t + 1]
            got, caches["card"] = T.decode_step(on_dev, cfg, {
                "tokens": tok.to(dev)}, caches["card"])
            want, caches["cpu"] = T.decode_step(params, cfg, {
                "tokens": tok}, caches["cpu"])
            w32, caches["f32"] = T.decode_step(params, cfg32, {
                "tokens": tok}, caches["f32"])
            assert dtypes(caches["card"]) == {(torch.float32,
                                               torch.bfloat16)}
            assert (got.cpu().float() - want.float()).abs().max() <= (
                want.float() - w32).abs().max()
        out = serve.generate(cfg, on_dev, toks[:, :4].to(dev), 4)
    assert tuple(out.shape) == (2, 8)


REVERSE = dict(param_dtype="bfloat16", activation_dtype="float32")


def bf16_step(x: float) -> float:
    """One bfloat16 step (unit in the last place) at |x|."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def test_lm_reverse_mix_forward_on_the_card(dev):
    """hymba-1.5b's smoke config with bfloat16 params and float32
    activations on the card: the forward's logits are float32, its SSD
    chunks launch ``ssd_chunk`` on the cuda tier (float32 operands), and
    the logits equal the plain route's within 1e-4 x max|logit| (the
    float32 LM tolerance: every product is float32); the loss within 1e-5
    relative and each gradient leaf (bfloat16, as its param) within one
    bfloat16 step at the plain leaf's max."""
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim.adamw import tree_leaves
    cfg = get_smoke_config("hymba-1.5b", **REVERSE)
    params = T.init_params(generator(0, dev), cfg, device=dev)
    assert {p.dtype for p in tree_leaves(params)} == {torch.bfloat16}
    toks = torch.randint(0, cfg.vocab_size, (2, 41), device=dev,
                         generator=generator(1, dev), dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    kernels.reset_launches()
    ops.reset_dispatch()
    with torch.no_grad():
        lk, aux = T.forward(params, cfg, batch)
    assert kernels.launches()["ssd_chunk"] == cfg.n_layers * 2
    assert ops.dispatch_breakdown()["ssd_chunk"] == {
        "cuda": cfg.n_layers * 2}
    with torch.no_grad():
        lp, _ = T.forward(params, cfg, batch, use_kernel=False)
    assert lk.dtype == aux["final_hidden"].dtype == torch.float32
    assert (lk - lp).abs().max() <= 1e-4 * lp.abs().max()
    (lossk, _, gk), (lossp, _, gp) = (
        steps.loss_and_grads(params, cfg, batch, use_kernel=k)
        for k in (True, False))
    assert abs(float(lossk) - float(lossp)) <= 1e-5 * abs(float(lossp))
    for g, w in zip(tree_leaves(gk), tree_leaves(gp)):
        assert g.dtype == w.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max() <= bf16_step(
            w.float().abs().max().item())


def test_lm_reverse_mix_decode_on_the_card(dev):
    """Reverse-mix decode of hymba-1.5b's smoke config on the card: the
    caches float32 (lengths int32) at init and after every step, every
    GQA layer's attention one ``flash_decode`` launch on the cuda tier a
    step, each step's logits (float32) equal the plain route's on the
    card within 1e-4 x max|logit|; ``generate`` runs."""
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("hymba-1.5b", **REVERSE)
    params = T.init_params(generator(0, dev), cfg, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 12), device=dev,
                         generator=generator(1, dev), dtype=torch.int32)
    caches = {k: T.init_cache(cfg, 2, 12, device=dev) for k in (True, False)}

    def dtypes(c):
        return {v.dtype for g in c for layer in g for m in layer.values()
                for v in m.values() if torch.is_tensor(v)}

    assert dtypes(caches[True]) == {torch.float32, torch.int32}
    kernels.reset_launches()
    ops.reset_dispatch()
    with torch.inference_mode():
        for t in range(12):
            tok = {"tokens": toks[:, t:t + 1]}
            got, caches[True] = T.decode_step(params, cfg, tok, caches[True])
            want, caches[False] = T.decode_step(params, cfg, tok,
                                                caches[False],
                                                use_kernel=False)
            assert got.dtype == torch.float32
            assert dtypes(caches[True]) == {torch.float32, torch.int32}
            assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert kernels.launches()["flash_decode"] == cfg.n_layers * 12
    assert ops.dispatch_breakdown()["flash_decode"] == {
        "cuda": cfg.n_layers * 12, "torch-ref": cfg.n_layers * 12}
    out = serve.generate(cfg, params, toks[:, :4], 4)
    assert tuple(out.shape) == (2, 8) and out.device.type == "cuda"


def moe_case(arch, b, s, capacity_factor):
    """A DeepSeek smoke MoE layer (the port's own draw) with its router on
    a 2^-10 grid and inputs on a 2^-4 grid in [-2, 2]: every router logit
    is exact in float32 on either device, so both route alike."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    cfg = get_smoke_config(arch)
    spec = dataclasses.replace(cfg.blocks[1].ffn,
                               capacity_factor=capacity_factor)
    p = L.init_moe_ffn(torch.Generator().manual_seed(26), cfg.d_model,
                       spec, torch.float32, "cpu")
    p["router"] = torch.round(p["router"] * 1024) / 1024
    if "router_bias" in p:
        p["router_bias"] = (torch.arange(spec.n_experts) % 3 - 1) / 16.0
    rng = np.random.default_rng([27, b, s])
    x = torch.as_tensor(np.clip(np.round(rng.normal(
        size=(b, s, cfg.d_model)) * 16) / 16, -2, 2).astype(np.float32))
    return spec, p, x


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "deepseek-v3-671b"])
@pytest.mark.parametrize("b,s,capacity_factor", [(2, 48, 1.25),
                                                 (2, 1100, 0.5)])
def test_moe_ffn_on_the_card_equals_the_cpu_and_is_deterministic(
        dev, arch, b, s, capacity_factor):
    """Dropless and capacity-dropping dispatch on the card: the CPU's
    result within 1e-4 * max|y| (the same routing, float sums in another
    order), the same per-expert counts, and two runs bit-identical (the
    combine gathers and sums in slot order: no float atomics)."""
    from repro_torch.models import layers as L
    spec, p, x = moe_case(arch, b, s, capacity_factor)
    want, want_aux = L.moe_ffn(p, spec, x)
    pd = {k: v.to(dev) for k, v in p.items()}
    got, aux = L.moe_ffn(pd, spec, x.to(dev))
    again, _ = L.moe_ffn(pd, spec, x.to(dev))
    assert torch.equal(got, again)
    assert (got.cpu() - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(aux["expert_counts"].cpu(), want_aux["expert_counts"])


def test_lm_families_launch_flash_decode(dev):
    """musicgen's and internvl2's smoke decode and deepseek-v2-lite's on
    the card: every GQA self-attention decode step one flash_decode
    launch on the cuda tier (MLA and cross-attention launch none), and
    the kernel path equals the plain one."""
    from repro_torch import generator
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    for arch in ("musicgen-medium", "internvl2-2b", "deepseek-v2-lite-16b"):
        cfg = get_smoke_config(arch)
        params = T.init_params(generator(0, dev), cfg, device=dev)
        gen = generator(1, dev)
        if cfg.frontend == "audio_frames":
            cond = torch.randn((2, cfg.n_cond_tokens, cfg.d_model),
                               generator=gen, device=dev)
            steps = [{"frame_embeds": torch.randn(
                (2, 1, cfg.d_model), generator=gen, device=dev),
                "cond_embeds": cond} for _ in range(6)]
        else:
            steps = [{"tokens": torch.randint(
                0, cfg.vocab_size, (2, 1), generator=gen, device=dev,
                dtype=torch.int32)} for _ in range(6)]
        out = {}
        for use_kernel in (True, False):
            kernels.reset_launches()
            ops.reset_dispatch()
            with torch.inference_mode():
                caches = T.init_cache(cfg, 2, 6, device=dev)
                out[use_kernel] = [T.decode_step(
                    params, cfg, sb, caches, use_kernel=use_kernel)[0]
                    for sb in steps]
            torch.cuda.synchronize()
            n_gqa = sum(b.repeat for b in cfg.blocks
                        if b.attn.kind == "gqa")
            if use_kernel:
                assert kernels.launches()["flash_decode"] == n_gqa * 6
                assert ops.dispatch_breakdown().get("flash_decode", {}) == (
                    {"cuda": n_gqa * 6} if n_gqa else {})
        for a, w in zip(out[True], out[False]):
            assert (a - w).abs().max() <= 1e-4 * w.abs().max()


def test_lm_wrappers_reject_bad_operands_and_a_failed_build_raises(
        dev, tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    q = torch.zeros((2, 4, 16), device=dev)
    k = torch.zeros((2, 8, 2, 16), device=dev)
    lens = torch.ones(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):  # cache_len must be int32
        flash_decode.flash_decode(q, k, k, lens.long())
    with pytest.raises(ValueError, match="different devices"):
        flash_decode.flash_decode(q, k, k.cpu(), lens)
    with pytest.raises(TypeError):  # the cache must be in q's dtype
        flash_decode.flash_decode(q, k.bfloat16(), k.bfloat16(), lens)
    x = torch.zeros((1, 4, 2, 8), device=dev)
    bc = torch.zeros((1, 4, 2, 200), device=dev)
    dt = torch.zeros((1, 4, 2), device=dev)
    s0 = torch.zeros((1, 2, 200, 8), device=dev)
    with pytest.raises(ValueError, match="outside"):  # N > 128
        ssd_chunk.ssd_chunk(x, bc, bc, dt, dt, s0)
    # A source that does not compile raises, and nothing falls back.
    bad = tmp_path / "csrc"
    bad.mkdir()
    (bad / "flash_decode.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC", bad)
    monkeypatch.setattr(_build, "SOURCES", ("flash_decode.cu",))
    monkeypatch.setattr(_build, "HEADERS", ())
    monkeypatch.setattr(_build, "_repo_root", lambda: tmp_path)
    with pytest.raises(RuntimeError, match="build failed"):
        _build.build()


# -- the autotuner and multi-device MEMHD ---------------------------------------

TUNE_SMALL = {"am_search_multibit": {"D": 128, "C": 96, "bits": 4},
              "am_search_packed": {"D": 1024, "C": 1024},
              "am_shortlist": {"D": 128, "G": 16, "S": 8},
              "am_search_sparse": {"D": 128, "T": 2, "K": 3},
              "encode_pack": {"f": 100, "D": 128},
              "qail_update": {"D": 128, "C": 64}}


@pytest.mark.parametrize("name", sorted(TUNE_SMALL))
def test_autotune_every_candidate_is_bit_exact(dev, name, tmp_path,
                                                monkeypatch):
    """The tuner on the card at one small geometry per spec: every
    candidate checked bit for bit against the plain version (a mismatch
    raises), timed on CUDA events; the entry names the card."""
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache.json"))
    spec = autotune.KERNELS[name]
    entry = autotune.autotune_kernel(name, TUNE_SMALL[name],
                                     batches=(32, 64), device=dev)
    assert entry["device"] == torch.cuda.get_device_name(dev)
    assert entry["power_limit_w"] > 0 and entry["sms"] > 0
    assert entry["timing"].startswith("cuda events")
    timed = set(entry["candidates_us"]) | set(entry["same_plan"]) \
        | set(entry["skipped_smem"])
    assert timed == {str(c) for c in spec.candidates}
    assert all(t > 0 for v in entry["candidates_us"].values()
               for t in v.values())
    assert entry["tuned_batches"] == [32, 64]
    assert ops.tuned_block_b(name, None, **TUNE_SMALL[name]) \
        == entry["block_b"]


def test_block_b_none_launches_the_cached_configuration(dev, tmp_path,
                                                        monkeypatch):
    from repro_torch.kernels import autotune
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "cache.json"))
    # The tiles this test resolves stay out of the process's memo.
    monkeypatch.setattr(autotune, "RESOLVED", {})
    name = torch.cuda.get_device_name(dev)
    for kernel, geometry, fields in (
            ("am_search_packed", "D256_C300", {"block_b": 32}),
            ("qail_update", "D256_C300", {"block_b": 64}),
            ("encode_pack", "f100_D256", {"block_b": 128, "tile": 0})):
        autotune.save_entry({"kernel": kernel, "device": name,
                             "geometry": geometry, "tuned_batches": [32, 64],
                             **fields})
    rng = np.random.default_rng(4)
    q = bipolar(rng, (40, 256), dev)
    am = bipolar(rng, (300, 256), dev)
    qp, amt = ref.pack_rows(q), ref.pack_rows(am).T.contiguous()
    x = feats(rng, (40, 100), dev, True)
    proj = bipolar(rng, (100, 256), dev)
    own = torch.as_tensor(rng.integers(0, 5, 300).astype(np.int32),
                          device=dev)
    y = torch.as_tensor(rng.integers(0, 5, 40).astype(np.int32), device=dev)
    m = torch.ones(40, device=dev)
    kernels.reset_launches()
    got = (ops.am_search_packed(qp, amt, n_dims=256),
           ops.qail_update(q, q, am.T, own, y, m, lr=0.0625),
           ops.encode_pack(x, proj))
    assert kernels.config_launches() == {"am_search_packed": {32: 1},
                                         "qail_update": {64: 1},
                                         "encode_pack": {0: 1}}
    want = (ops.am_search_packed(qp, amt, n_dims=256, block_b=8),
            ops.qail_update(q, q, am.T, own, y, m, lr=0.0625, block_b=16),
            ops.encode_pack(x, proj, block_b=64))
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(a, b)
    # Outside the tuned batches, and in unpack mode (not tuned), the
    # default runs.
    kernels.reset_launches()
    ops.am_search_packed(qp[:8], amt, n_dims=256)
    ops.qail_update(q[:8], q[:8], am.T, own, y[:8], m[:8], lr=0.0625)
    ops.encode_pack(x[:8], proj)
    ops.am_search_packed(qp, amt, n_dims=256, mode="unpack")
    assert kernels.config_launches() == {"am_search_packed": {8: 2},
                                         "qail_update": {16: 1},
                                         "encode_pack": {3: 1}}
    autotune.save_entry({"kernel": "am_search_packed", "device": name,
                         "geometry": "D256_C300", "block_b": 64,
                         "tuned_batches": [32, 64]})
    with pytest.raises(ValueError, match="cache.json"):
        ops.am_search_packed(qp, amt, n_dims=256)


def _small_model(dev):
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=40, test_per_class=10,
                      device=dev)
    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = MemhdConfig(dim=128, columns=64, classes=ds.classes, epochs=2,
                      kmeans_iters=5)
    m, _ = MemhdModel.create(0, enc, amc, device=dev).fit(
        1, ds.train_x, ds.train_y, use_kernel=True)
    return m, ds


@pytest.mark.parametrize("target,kw", [
    ("packed", {}), ("packed", {"mode": "unpack"}), ("unpacked", {}),
    ("imc", {}), ("multibit", {"cell_bits": 4}), ("hierarchical", {})])
def test_sharded_on_one_card_equals_the_unwrapped_artifact(dev, target, kw):
    from repro_torch.deploy import ShardedArtifact
    m, ds = _small_model(dev)
    dep = m.deploy(target=target, **kw)
    sh = ShardedArtifact(dep, mesh=(dev, dev))
    assert sh.n_devices == 2 and sh.device.type == dev.type
    ofs = 0
    for rows in (1, 7, 33, 100):
        x = ds.test_x[ofs:ofs + rows]
        ofs += rows
        assert torch.equal(sh.predict(x), dep.predict(x))
        assert torch.equal(sh.predict_features(x), dep.predict_features(x))
        if target == "hierarchical":
            for a, b in zip(sh.predict_topk(x, 5), dep.predict_topk(x, 5)):
                assert torch.equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_qail_batch_delta_kernel_route_equals_the_plain_one(dev, masked):
    """The ±1 payload at lr = 2^-4, at most 256 terms a cell: every sum
    is exact in bfloat16, so the kernel route (one qail_update launch, its
    float32 delta rounded once) equals the plain row-order bfloat16
    version on the CPU bit for bit."""
    from repro_torch.core import qail, types
    rng = np.random.default_rng([9, masked])
    b, d, c = 256, 200, 96
    fp = rng.normal(size=(c, d)).astype(np.float32)
    state = {"fp": fp, "binary": np.where(fp >= 0, 1.0, -1.0)
             .astype(np.float32),
             "centroid_class": rng.integers(0, 6, c).astype(np.int32)}
    q = rng.choice([-1.0, 1.0], (b, d)).astype(np.float32)
    y = rng.integers(0, 6, b).astype(np.int32)
    mask = (rng.random(b) < 0.7).astype(np.float32) if masked else None
    cfg = types.MemhdConfig(dim=d, columns=c, classes=6, lr=0.0625,
                            update_with="binary")
    out = {}
    for where in (dev, torch.device("cpu")):
        st = {k: torch.as_tensor(v, device=where) for k, v in state.items()}
        t = (lambda a: None if a is None
             else torch.as_tensor(a, device=where))
        kernels.reset_launches()
        out[where.type] = qail.qail_batch_delta(st, cfg, t(q), t(q), t(y),
                                                mask=t(mask))
        if where.type == "cuda":
            assert kernels.launches()["qail_update"] == 1
            assert qail_update.route_counts() == {"int8": 1, "fp32": 0}
    (kd, km), (pd, pm) = out["cuda"], out["cpu"]
    assert kd.dtype == torch.bfloat16
    assert torch.equal(kd.cpu(), pd) and float(km) == float(pm) > 0


@pytest.mark.parametrize("target,kw", [
    ("packed", {}), ("packed", {"mode": "unpack"}), ("unpacked", {}),
    ("imc", {}), ("multibit", {"cell_bits": 4}), ("hierarchical", {})])
def test_sharded_across_the_card_and_the_cpu(dev, target, kw):
    """A mesh of two distinct devices, (card, cpu): the artifact is copied
    to the CPU once (one replica), each shard runs on its own device (the
    card's kernels, the CPU's plain versions), the outputs gather on the
    card and equal the unwrapped artifact's. Dyadic features keep the
    fp32 encode exact on both devices."""
    from repro_torch.deploy import ShardedArtifact
    m, ds = _small_model(dev)
    dep = m.deploy(target=target, **kw)
    cpu = torch.device("cpu")
    sh = ShardedArtifact(dep, mesh=(dev, cpu))
    reps = sh._replicas.of(dep, set(sh.mesh))
    assert list(reps) == [cpu] and len(sh._replicas) == 1
    rep = reps[cpu]
    assert rep.device.type == "cpu" and rep is not dep
    x_all = torch.round(ds.test_x * 256) / 256
    ofs = 0
    for rows in (1, 7, 33, 100):
        x = x_all[ofs:ofs + rows]
        ofs += rows
        kernels.reset_launches()
        got = sh.predict(x)
        assert got.device == x.device
        assert torch.equal(got, dep.predict(x))
        assert torch.equal(sh.predict_features(x), dep.predict_features(x))
        if target == "hierarchical":
            for a, b in zip(sh.predict_topk(x, 5), dep.predict_topk(x, 5)):
                assert a.device == x.device and torch.equal(a, b)
    assert sum(kernels.launches().values()) > 0
    # A swap copies the new artifact to the CPU once and shares the cache.
    new = sh.refresh(m)
    assert new._replicas is sh._replicas and len(sh._replicas) == 2
    assert torch.equal(new.predict(x), dep.predict(x))


def test_fit_sharded_across_the_card_and_the_cpu(dev):
    """fit_sharded over (card, cpu) under exact conditions equals the
    one-shard fit on the card: the card's shard delta is a qail_update
    launch, the CPU's the plain row-order bfloat16 version, and the
    replicas of fp / binary move between the two devices every batch."""
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=40, test_per_class=10,
                      device=dev)
    x = torch.round(ds.train_x * 16) / 16
    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = MemhdConfig(dim=128, columns=32, classes=ds.classes, epochs=3,
                      kmeans_iters=5, batch_size=128, lr=0.0625,
                      update_with="binary")
    m = MemhdModel.create(0, enc, amc, device=dev)
    nb = -(-x.shape[0] // 128)
    fits = {}
    for mesh in ((dev,), (dev, torch.device("cpu"))):
        kernels.reset_launches()
        fits[len(mesh)] = m.fit_sharded(1, x, ds.train_y, mesh=mesh)
        assert kernels.launches()["qail_update"] == nb * 3
        assert qail_update.route_counts()["fp32"] == 0
    (m1, h1), (m2, h2) = fits[1], fits[2]
    for key in ("fp", "binary"):
        assert m2.am_state[key].device == m1.am_state[key].device
        assert torch.equal(m1.am_state[key], m2.am_state[key])
    assert h1["curve"] == h2["curve"]


def test_fit_sharded_two_shards_on_one_card(dev):
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    ds = load_dataset("mnist", train_per_class=40, test_per_class=10,
                      device=dev)
    x = torch.round(ds.train_x * 16) / 16
    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    amc = MemhdConfig(dim=128, columns=32, classes=ds.classes, epochs=3,
                      kmeans_iters=5, batch_size=128, lr=0.0625,
                      update_with="binary")
    m = MemhdModel.create(0, enc, amc, device=dev)
    fits = {}
    for mesh in ((dev,), (dev, dev)):
        kernels.reset_launches()
        fits[len(mesh)] = m.fit_sharded(1, x, ds.train_y, mesh=mesh)
        nb = -(-x.shape[0] // 128)
        assert kernels.launches()["qail_update"] == len(mesh) * nb * 3
        assert qail_update.route_counts()["fp32"] == 0
    (m1, h1), (m2, h2) = fits[1], fits[2]
    for key in ("fp", "binary"):
        assert torch.equal(m1.am_state[key], m2.am_state[key])
    assert h1["curve"] == h2["curve"]


# -- the sharded LM paths: flash_decode's partials, the sequence-parallel
# decode and the expert-parallel MoE over (cuda:0, cuda:0) ---------------------

@pytest.mark.parametrize("s", [1, 64, 320, 4097])
@pytest.mark.parametrize("softcap", [None, 2.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_return_lse(dev, s, softcap, dtype):
    """The LSE read from the launch's per-split partials against the plain
    version's; -inf on the row with cache_len 0, whose output is 0; the
    output is float32, and rounded to q's dtype it is the same launch's
    output as without ``return_lse``."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng([s, 77])
    q, k, v, lens = flash_decode_case(rng, 4, s, 10, 2, 64, dt, dev)
    got, lse = flash_decode.flash_decode(q, k, v, lens, softcap=softcap,
                                         return_lse=True)
    want, wlse = ref.flash_decode(q, k, v, lens, softcap, return_lse=True)
    assert_flash_decode(got, want, dt)
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got.to(dt), flash_decode.flash_decode(
        q, k, v, lens, softcap=softcap))
    assert lse.shape == (4, 10) and lse.dtype == torch.float32
    assert torch.isneginf(lse[1]).all() and (got[1] == 0).all()
    fin = torch.isfinite(wlse)
    assert torch.equal(fin, torch.isfinite(lse))
    err = (lse - wlse)[fin].abs()
    assert (err <= 1e-4 + 1e-5 * wlse[fin].abs()).all(), err.max().item()


def _one_card_rules(**kw):
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    return make_rules(make_test_mesh((1, 2), devices="cuda:0"), **kw)


def test_seq_parallel_decode_on_one_card_twice(dev):
    from repro_torch.models import layers as L
    from repro_torch.models.config import AttnSpec
    from repro_torch.models.sharding import use_rules
    spec = AttnSpec(kind="gqa", n_heads=8, n_kv_heads=2, head_dim=64,
                    logit_softcap=30.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = L.init_gqa(gen, 128, spec, torch.float32, dev)
    x = torch.randn((3, 12, 128), generator=gen, device=dev)
    rules = _one_card_rules(shard_seq=True)
    caches = [L.init_gqa_cache(spec, 3, 256, torch.float32, dev)]
    with use_rules(rules):
        caches.append(L.init_gqa_cache(spec, 3, 256, torch.float32, dev,
                                       seq_parallel=True))
    kernels.reset_launches()
    for i in range(12):
        want, caches[0] = L.gqa_decode(p, spec, x[:, i:i + 1], caches[0])
        with use_rules(rules):
            got, caches[1] = L.gqa_decode(p, spec, x[:, i:i + 1], caches[1],
                                          seq_parallel=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert kernels.launches()["flash_decode"] == 12 * 3
    assert torch.equal(L.seq_gather_cache(caches[1], rules)["k"],
                       caches[0]["k"])


def test_expert_parallel_moe_on_one_card_twice(dev):
    from repro_torch.models import layers as L
    from repro_torch.models.config import FfnSpec
    spec = FfnSpec(kind="moe", d_ff=64, n_experts=8, n_shared=1, top_k=2,
                   d_ff_expert=32, router="softmax", capacity_factor=8.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    p = L.init_moe_ffn(gen, 64, spec, torch.float32, dev)
    x = torch.randn((4, 16, 64), generator=gen, device=dev)
    want, aux0 = L.moe_ffn(p, spec, x)
    got, aux = L.moe_ffn(p, spec, x, rules=_one_card_rules())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(aux["expert_counts"], aux0["expert_counts"])
    assert got.device == x.device


def test_record_names_the_card_and_its_power_limit(dev, tmp_path):
    import json
    import subprocess
    from repro_torch.obs import record
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0]
    name, limit = (v.strip() for v in out.split(","))
    path = record.from_report("demo", {"qps": 2.0, "backend": "packed"},
                              str(tmp_path), device=dev)
    rec = json.loads(open(path).read())
    assert rec["device"] == {"platform": "gpu", "name": name,
                             "power_limit_w": float(limit),
                             "count": torch.cuda.device_count()}
    assert rec["device"]["name"] == torch.cuda.get_device_name(dev)
