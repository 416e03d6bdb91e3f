"""bfloat16 params with float32 activations (the reverse mix) in the port's
LM stack against the JAX package's, on the CPU, at every registered
architecture's smoke config made reverse-mixed: ``forward`` logits and
aux, teacher-forced ``decode_step`` logits with the caches' dtypes after
every step (float32 caches; with ``kv_cache_quant`` int8 rows and float16
scales), for all ten architectures and for qwen's int8 KV cache.
tests/test_torch_lm_reverse_train.py holds the loss, the gradients and the
train step to the reference; tests/test_torch_lm_reverse_paths.py
``generate``, the sharded paths and the checkpoint.

The reference's params (``T.init_params(jax.random.key(0), cfg)``:
bfloat16, the MoE routers float32) cross through
``convert.lm_params_from_numpy`` bit for bit; tokens and embeddings come
from numpy. Every product of a float32 activation with a bfloat16 weight
is a float32 product of the same numbers on both sides, so the float32
tolerance holds: |port - reference| <= 1e-4 * max|reference|
(``MODEL_TOL``, as tests/test_torch_lm_families.py; measured at most
2.2e-6 of max|logit|, deepseek-v2-lite's decode).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from test_torch_lm_families import (  # noqa: E402
    inputs, same_quant_rows, to_jax, to_port,
)

REVERSE = dict(param_dtype="bfloat16", activation_dtype="float32")
MODEL_TOL = 1e-4
QUANT_TOL = 5e-2  # tests/test_kv_quant.py: int8-cache decode vs forward
B = 2


def reverse(arch, pkg=configs, **kw):
    """``arch``'s smoke config with bfloat16 params and float32
    activations (``kw`` replaces further fields)."""
    return pkg.get_smoke_config(arch, **REVERSE, **kw)


_CROSSED = {}


def crossed(arch, **kw):
    """(port cfg, port params, reference cfg, reference params) of the
    reverse mix, the reference's params drawn once per arch (jitted: the
    same draws as eager init) and crossed bit for bit."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CROSSED:
        jcfg, cfg = reverse(arch, jax_configs, **kw), reverse(arch, **kw)
        jparams = jax.jit(lambda k: JT.init_params(k, jcfg)[0])(
            jax.random.key(0))
        params = convert.lm_params_from_numpy(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _CROSSED[key] = cfg, params, jcfg, jparams
    return _CROSSED[key]


def model_close(got, want):
    assert got.dtype == torch.float32
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def bf16_step(x: float) -> float:
    """One bfloat16 step (unit in the last place) at |x|."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def cache_dtypes(caches) -> list:
    """Per group, per layer: {(mixer, leaf): dtype name} of the port's
    caches."""
    return [[{(m, k): name(v.dtype) for m, c in layer.items()
              for k, v in c.items() if torch.is_tensor(v)}
             for layer in group] for group in caches]


def reference_cache_dtypes(jcaches, cfg) -> list:
    """The reference's stacked caches in ``cache_dtypes``' layout."""
    return [[{(m, k): str(v.dtype) for m, c in group.items()
              for k, v in c.items()}] * b.repeat
            for group, b in zip(jcaches, cfg.blocks)]


def params_are_reverse(params):
    """Every leaf bfloat16 but the MoE routers (float32)."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        else:
            yield path, tree
    for path, leaf in walk(params):
        router = path.endswith(("/router", "/router_bias"))
        assert leaf.dtype == (torch.float32 if router else torch.bfloat16), \
            path


def test_the_reverse_mix_is_let_through_on_every_arch():
    for arch in configs.list_archs():
        T.check_supported(reverse(arch))
    with pytest.raises(NotImplementedError, match="TypeError"):
        T.check_supported(configs.get_smoke_config(
            "qwen1.5-32b", param_dtype="float32",
            activation_dtype="bfloat16"))


@pytest.mark.parametrize("arch", configs.list_archs())
def test_forward_and_decode_match_the_reference(arch):
    """B 2, S 40 or 72 (plus 16 patches for internvl2): forward's logits
    (float32) and aux, then every teacher-forced decode step's logits, and
    the caches' dtypes at init and after every step, against the
    reference's. The GQA decode runs ``flash_decode``'s plain version on
    float32 operands once per GQA layer a step."""
    cfg, params, jcfg, jparams = crossed(arch)
    params_are_reverse(params)
    batch, steps = inputs(cfg, 40)
    want, jaux = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        jparams, to_jax(batch))
    with torch.inference_mode():
        got, aux = T.forward(params, cfg, to_port(batch))
    model_close(got, want)
    assert sorted(aux) == sorted(jaux)
    assert aux["final_hidden"].dtype == torch.float32
    for k, v in jaux.items():
        if k.startswith("expert_counts"):
            assert np.array_equal(aux[k].numpy(), np.asarray(v))
        elif k == "lb_loss":
            np.testing.assert_allclose(aux[k].item(), float(v), rtol=1e-5)
        else:
            model_close(aux[k], v)

    step = jax.jit(lambda p, b, c: JT.decode_step(p, jcfg, b, c))
    jcaches = JT.init_cache(jcfg, B, len(steps))
    ops.reset_dispatch()
    with torch.inference_mode():
        caches = T.init_cache(cfg, B, len(steps), device="cpu")
        assert cache_dtypes(caches) == reference_cache_dtypes(jcaches, cfg)
        assert {d for g in cache_dtypes(caches) for layer in g
                for d in layer.values()} == {"float32", "int32"}
        for sb in steps:
            lg, jcaches = step(jparams, to_jax(sb), jcaches)
            dec, caches = T.decode_step(params, cfg, to_port(sb), caches)
            model_close(dec, lg)
            assert cache_dtypes(caches) == reference_cache_dtypes(jcaches,
                                                                  cfg)
    n_gqa = sum(b.repeat for b in cfg.blocks
                if b.mixer in ("attn", "hybrid") and b.attn.kind == "gqa")
    assert ops.dispatch_breakdown().get("flash_decode", {}) == (
        {"torch-ref": n_gqa * len(steps)} if n_gqa else {})


def test_int8_cache_decode_matches_the_reference():
    """qwen1.5-32b's smoke config, reverse mix, ``kv_cache_quant``: the
    caches int8 with float16 scales (and int32 lengths) at init and after
    every step, as the reference's; over 64 teacher-forced steps every step
    where both sides hold the same int8 rows within MODEL_TOL of the
    reference's logits, and the last within QUANT_TOL * max|logit| of the
    port's float forward."""
    cfg, params, jcfg, jparams = crossed("qwen1.5-32b", kv_cache_quant=True)
    s = 64
    toks = np.random.default_rng(41).integers(
        0, cfg.vocab_size, size=(B, s)).astype(np.int32)
    step = jax.jit(lambda p, b, c: JT.decode_step(p, jcfg, b, c))
    jcaches = JT.init_cache(jcfg, B, s)
    compared = 0
    with torch.inference_mode():
        fwd, _ = T.forward(params, cfg, to_port({"tokens": toks}))
        caches = T.init_cache(cfg, B, s, device="cpu")
        assert {d for g in cache_dtypes(caches) for layer in g
                for d in layer.values()} == {"int8", "float16", "int32"}
        for i in range(s):
            sb = {"tokens": toks[:, i:i + 1]}
            lg, jcaches = step(jparams, to_jax(sb), jcaches)
            dec, caches = T.decode_step(params, cfg, to_port(sb), caches)
            assert cache_dtypes(caches) == reference_cache_dtypes(jcaches,
                                                                  cfg)
            if same_quant_rows(caches, jcaches):
                model_close(dec, lg)
                compared += 1
    assert compared >= s - 8, compared
    last = fwd[:, -1]
    assert (dec - last).abs().max().item() < QUANT_TOL * last.abs().max() \
        .item()
    assert {x.dtype for x in tree_leaves(params)} == {torch.bfloat16}
