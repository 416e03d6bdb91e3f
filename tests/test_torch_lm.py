"""The port's LM stack against the JAX package's, on the CPU.

Operands come from numpy (seeded) and feed both packages; model params
are the reference's (``T.init_params(jax.random.key(0), cfg)``) crossed
through ``convert.lm_params_from_numpy``. Everything runs in float32, so
the two sides differ only by summation order. Tolerances:
- the plain kernels against the Pallas kernels in interpret mode:
  ``flash_decode`` rtol = atol = 3e-5 and ``ssd_chunk`` 1e-4, the JAX
  package's own tests' tolerances (tests/test_flash_decode.py,
  tests/test_ssd_kernel.py); in bfloat16 one bf16 ulp of the reference
  plus 3e-5 (both compute in float32 and round once);
- layers and whole models: |port - reference| <= 1e-4 * max|reference|
  (float32 sums over at most a few thousand terms per layer differ by
  ~1e-6 relative; a wrong mask, decay or head mapping moves logits by
  O(1));
- decode against forward within the port: the reference's own criterion
  2e-2 * max|logits| (tests/test_models.py).
The whole models are held against the reference in
tests/test_torch_lm_model.py; the CUDA kernels against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.kernels.flash_decode import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.ssd_chunk import ref_ssd_chunk as jax_ref_ssd_chunk  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_chunk as sc  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

MODEL_TOL = 1e-4


def t(a):
    return torch.tensor(np.asarray(a))


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def model_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def bf16(a):
    """A jax bfloat16 array as a torch bfloat16 tensor, bit for bit."""
    return torch.tensor(np.asarray(a).view(np.int16)).view(torch.bfloat16)


def bf16_ulp(x):
    _, e = np.frexp(np.abs(np.asarray(x, np.float32)))
    return np.ldexp(1.0, e - 8)


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_config_equals_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        ours = getattr(configs, get)(arch)
        theirs = getattr(jax_configs, get)(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), get
        assert ours.param_count() == theirs.param_count()
        assert ours.active_param_count() == theirs.active_param_count()
        assert ours.padded_vocab == theirs.padded_vocab
    over = configs.get_config(arch, param_dtype="float32")
    assert over.param_dtype == "float32"


def test_registry_equals_the_reference():
    assert configs.ARCHS == jax_configs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert list(configs.cells(True)) == list(jax_configs.cells(True))
    assert list(configs.cells()) == list(jax_configs.cells())


# -- flash_decode -------------------------------------------------------------

def decode_case(rng, b, s, h, kv, dh, lens):
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    return q, k, v, np.asarray(lens, np.int32)


# tests/test_flash_decode.py's shapes (GQA 4x, MHA, MQA with ragged S,
# exactly one block) at full length, and ragged rows with lengths 0 and 1.
DECODE_CASES = [
    (2, 256, 8, 2, 64, None), (1, 384, 4, 4, 128, None),
    (3, 130, 6, 1, 32, None), (2, 128, 16, 8, 64, None),
    (3, 256, 4, 2, 64, [17, 200, 256]), (4, 130, 10, 2, 16, [0, 1, 129, 64]),
]


@pytest.mark.parametrize("b,s,h,kv,dh,lens", DECODE_CASES)
def test_flash_decode_plain_matches_the_pallas_kernel(b, s, h, kv, dh, lens):
    rng = np.random.default_rng([7, b, s, h, kv, dh])
    q, k, v, ln = decode_case(rng, b, s, h, kv, dh,
                              [s] * b if lens is None else lens)
    want = np.asarray(jax_flash_decode(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(ln)))
    got = ref.flash_decode(t(q), t(k), t(v), t(ln))
    close(got, want, 3e-5, 3e-5)
    # The wrapper and the dispatch take the plain version on the CPU.
    assert torch.equal(fd.flash_decode(t(q), t(k), t(v), t(ln)), got)
    assert torch.equal(ops.flash_decode(t(q), t(k), t(v), t(ln)), got)
    if lens is not None and 0 in lens:
        assert not got[lens.index(0)].any()  # an empty row yields 0


def test_flash_decode_plain_bf16_and_single_token():
    rng = np.random.default_rng(8)
    q, k, v, ln = decode_case(rng, 2, 256, 4, 2, 64, [256, 1])
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash_decode(qb, kb, vb, jnp.asarray(ln)),
                      np.float32)
    got = ref.flash_decode(*(bf16(a) for a in (qb, kb, vb)), t(ln))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= bf16_ulp(want) + 3e-5).all(), err.max()
    # Attention over one key is that key's value.
    close(got[1].float(), np.asarray(vb[1, 0], np.float32).repeat(2, 0),
          0, 0)


# -- ssd_chunk ----------------------------------------------------------------

def chunk_inputs(rng, b, q, h, n, p):
    x = rng.normal(size=(b, q, h, p)).astype(np.float32)
    bb = rng.normal(size=(b, q, h, n)).astype(np.float32)
    cc = rng.normal(size=(b, q, h, n)).astype(np.float32)
    dt = np.abs(rng.normal(size=(b, q, h))).astype(np.float32) * 0.1
    da = -dt * np.abs(rng.normal(size=(b, q, h))).astype(np.float32)
    s0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return x, bb, cc, dt, da, s0


# tests/test_ssd_kernel.py's shapes: mamba2-130m (N 128) and hymba (N 16)
# geometries among them, plus a 1-step and a 20-step chunk.
SSD_CASES = [(2, 64, 3, 32, 16), (1, 128, 24, 128, 64), (1, 256, 4, 16, 64),
             (3, 32, 2, 16, 8), (2, 1, 3, 16, 64), (1, 20, 5, 16, 64)]


@pytest.mark.parametrize("b,q,h,n,p", SSD_CASES)
def test_ssd_chunk_plain_matches_oracle_and_pallas_kernel(b, q, h, n, p):
    args = chunk_inputs(np.random.default_rng([11, b, q, h, n, p]),
                        b, q, h, n, p)
    y, s_new = ref.ssd_chunk(*(t(a) for a in args))
    jargs = [jnp.asarray(a) for a in args]
    for fn in (jax_ref_ssd_chunk, jax_ssd_chunk):
        y_w, s_w = fn(*jargs)
        close(y, y_w, 1e-4, 1e-4)
        close(s_new, s_w, 1e-4, 1e-4)
    assert s_new.dtype == torch.float32
    for fn in (sc.ssd_chunk, ops.ssd_chunk):
        y2, s2 = fn(*(t(a) for a in args))
        assert torch.equal(y2, y) and torch.equal(s2, s_new)


def test_ssd_chunk_plain_state_carry_composes():
    """Two chained chunks == one chunk of twice the length."""
    b, q, h, n, p = 1, 32, 2, 16, 8
    x, bb, cc, dt, da, s0 = (t(a) for a in chunk_inputs(
        np.random.default_rng(12), b, 2 * q, h, n, p))
    y_full, s_full = ref.ssd_chunk(x, bb, cc, dt, da, s0)
    y1, s1 = ref.ssd_chunk(x[:, :q], bb[:, :q], cc[:, :q], dt[:, :q],
                           da[:, :q], s0)
    y2, s2 = ref.ssd_chunk(x[:, q:], bb[:, q:], cc[:, q:], dt[:, q:],
                           da[:, q:], s1)
    close(torch.cat([y1, y2], 1), y_full, 1e-4, 1e-4)
    close(s2, s_full, 1e-4, 1e-4)


# -- layers -------------------------------------------------------------------

def jax_layer_params(init, *args):
    p, _ = init(jax.random.key(3), *args)
    return {k: t(v) for k, v in p.items()}, p


@pytest.mark.parametrize("arch,s", [("hymba-1.5b", 96), ("hymba-1.5b", 70),
                                    ("mamba2-130m", 96)])
def test_ssd_forward_chained_chunks_match_the_reference(arch, s):
    cfg = configs.get_smoke_config(arch)
    spec = cfg.blocks[-1].ssm
    ours, theirs = jax_layer_params(JL.init_ssm, cfg.d_model, spec,
                                    jnp.float32)
    x = np.random.default_rng([13, s]).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    want = JL.ssd_forward(theirs, spec, cfg.d_model, jnp.asarray(x))
    ops.reset_dispatch()
    got = L.ssd_forward(ours, spec, cfg.d_model, t(x))
    model_close(got, want)
    assert ops.dispatch_breakdown()["ssd_chunk"] == {
        "torch-ref": -(-s // spec.chunk)}


@pytest.mark.parametrize("window", [None, 32])
def test_gqa_forward_matches_the_reference(window):
    cfg = configs.get_smoke_config("hymba-1.5b")
    spec = dataclasses.replace(cfg.blocks[0].attn, window=window)
    ours, theirs = jax_layer_params(JL.init_gqa, cfg.d_model, spec,
                                    jnp.float32)
    x = np.random.default_rng(14).normal(
        size=(2, 96, cfg.d_model)).astype(np.float32)
    pos = np.arange(96)[None].repeat(2, 0)
    want = JL.gqa_forward(theirs, spec, jnp.asarray(x), jnp.asarray(pos))
    model_close(L.gqa_forward(ours, spec, t(x), t(pos)), want)


# -- the sequence-parallel decode's config flag ---------------------------

SEQ_PARALLEL = {
    "seq_parallel": lambda: configs.get_smoke_config(
        "hymba-1.5b", seq_parallel_decode=True),
}


@pytest.mark.parametrize("what", sorted(SEQ_PARALLEL))
def test_seq_parallel_flag_without_rules_decodes_as_unflagged(what):
    """With ``seq_parallel_decode`` set, the config inits, builds caches
    and crosses the reference's params, and without sharding rules it
    decodes exactly as the unflagged config (the sequence-parallel path
    needs rules with ``shard_seq``; it is held against the reference in
    tests/test_torch_lm_sharded.py)."""
    cfg = SEQ_PARALLEL[what]()
    assert isinstance(cfg, ModelConfig) and cfg.seq_parallel_decode
    plain = dataclasses.replace(cfg, seq_parallel_decode=False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    crossed = convert.lm_params_from_numpy(
        {k: v for k, v in _numpy_tree(params).items()}, cfg, device="cpu")
    assert T.param_axes(cfg) == T.param_axes(plain)
    caches = [T.init_cache(c, 2, 8, device="cpu") for c in (cfg, plain)]
    toks = torch.tensor([[3], [5]])
    for _ in range(3):
        got, caches[0] = T.decode_step(crossed, cfg, {"tokens": toks},
                                       caches[0])
        want, caches[1] = T.decode_step(params, plain, {"tokens": toks},
                                        caches[1])
        assert torch.equal(got, want)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.numpy()


def test_seq_parallel_gqa_decode_matches_the_local_decode():
    """``seq_parallel=True`` without rules is the local GQA decode bit for
    bit, and under rules over two CPU "model" members it agrees with it
    within 1e-5 (a softcapped layer). The decode softcap and the int8
    cache are held against the reference in tests/test_torch_lm_mla_moe.py
    and tests/test_torch_lm_families.py, the sequence-parallel decode in
    tests/test_torch_lm_sharded.py."""
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    from repro_torch.models.sharding import use_rules
    cfg = configs.get_smoke_config("hymba-1.5b")
    spec = dataclasses.replace(cfg.blocks[0].attn, logit_softcap=30.0,
                               window=None)
    gen = torch.Generator().manual_seed(0)
    p = L.init_gqa(gen, cfg.d_model, spec, torch.float32, "cpu")
    x = torch.randn((2, 4, cfg.d_model), generator=gen)
    rules = make_rules(make_test_mesh((1, 2), devices="cpu"), shard_seq=True)
    caches = [L.init_gqa_cache(spec, 2, 8, torch.float32, "cpu",
                               seq_parallel=True) for _ in range(2)]
    with use_rules(rules):
        caches.append(L.init_gqa_cache(spec, 2, 8, torch.float32, "cpu",
                                       seq_parallel=True))
    for i in range(4):
        xi = x[:, i:i + 1]
        y0, caches[0] = L.gqa_decode(p, spec, xi, caches[0])
        y1, caches[1] = L.gqa_decode(p, spec, xi, caches[1],
                                     seq_parallel=True)
        with use_rules(rules):
            y2, caches[2] = L.gqa_decode(p, spec, xi, caches[2],
                                         seq_parallel=True)
        assert torch.equal(y0, y1)
        torch.testing.assert_close(y2, y0, rtol=1e-5, atol=1e-5)
    assert isinstance(caches[2]["k"], list) and len(caches[2]["k"]) == 2
    assert torch.equal(L.seq_gather_cache(caches[2], rules)["k"],
                       caches[0]["k"])
    assert torch.isfinite(y0).all() and caches[0]["len"].tolist() == [4, 4]
    cache = L.init_gqa_cache(spec, 1, 8, torch.float32, "cpu")
    xq = torch.ones((1, 1, cfg.d_model))
    qcache = L.init_gqa_cache(spec, 1, 8, torch.float32, "cpu", quant=True)
    assert qcache["k_q"].dtype == torch.int8
    yq, qcache = L.gqa_decode_quant(p, spec, xq, qcache)
    assert torch.isfinite(yq).all() and qcache["len"].tolist() == [1]
    y, cache = L.gqa_decode(p, spec, xq, cache)
    assert torch.isfinite(y).all() and cache["len"].tolist() == [1]
    # The prefill path keeps the softcap (plain attention, no kernel).
    out = L.gqa_forward(p, spec, torch.ones((1, 4, cfg.d_model)),
                        torch.arange(4))
    assert torch.isfinite(out).all()
