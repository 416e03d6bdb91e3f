"""The port's LM layers that serve DeepSeek, MusicGen and the int8 KV cache,
against the JAX package's, on the CPU: ``_quant_rows`` and
``gqa_decode_quant``, MLA (``mla_forward``, the absorbed ``mla_decode``,
with and without q-LoRA), the MoE FFN (softmax and sigmoid-plus-bias
routers, both sides of the 4096-slot capacity switch, dropped slots,
shared experts, aux; the routers crossing as float32 in a bfloat16
model), cross-attention, and the decode softcap through the plain
``flash_decode``.

Operands come from numpy seeds; layer params are the reference's
(``init_*(jax.random.key(3), ...)``) crossed as float32 tensors. All in
float32. Tolerance: |port - reference| <= 1e-4 * max|reference|
(``MODEL_TOL``, as tests/test_torch_lm.py). The MoE inputs and router
sit on dyadic grids small enough that every router logit is exact in
float32 in any summation order, so both sides route every token alike;
exact ties are frequent on such a grid and exercise the lower-index-first
selection.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

MODEL_TOL = 1e-4


def t(a):
    return torch.tensor(np.asarray(a))


def model_close(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= MODEL_TOL * np.abs(want).max(), (err, np.abs(want).max())


def crossed(init, *args):
    """(port params, reference params) of one reference layer init."""
    p, _ = init(jax.random.key(3), *args)
    return jax.tree.map(t, p), p


def normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- the int8 KV cache --------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_rows_equal_the_reference(dtype):
    x = normal(30, (4, 8, 3, 16)) * 3.0
    x[1, 2] = 0.0  # all-zero rows: the 1e-8 floor keeps the scale finite
    jx = jnp.asarray(x).astype(dtype)
    want_q, want_s = JL._quant_rows(jx)
    got_q, got_s = L._quant_rows(t(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float16
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[1, 2].any()


def quant_spec(window, softcap):
    base = configs.get_smoke_config("qwen1.5-32b").blocks[0].attn
    return dataclasses.replace(base, n_kv_heads=2, window=window,
                               logit_softcap=softcap)


def same_quant_rows(cache, jcache) -> bool:
    """Whether the port's int8 cache holds the reference's rows and scales.

    Where it does not, the rows differ at rounding boundaries only: a
    K / V value whose quotient by its row scale lies within float32
    rounding of a half step rounds one int8 step apart on the two sides
    (their projections and RoPE differ in the last bit). Then the
    reference's rows are copied into the port's cache, so the next
    steps start from one quantized state again."""
    same = True
    for name in ("k_q", "v_q", "k_s", "v_s"):
        got, want = cache[name], np.asarray(jcache[name])
        if np.array_equal(got.numpy(), want):
            continue
        same = False
        if name.endswith("_q"):
            assert np.abs(got.numpy().astype(np.int32)
                          - want.astype(np.int32)).max() == 1
        else:
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), rtol=1e-3)
        got.copy_(t(want))
    return same


@pytest.mark.parametrize("window,softcap", [(None, None), (8, None),
                                            (None, 5.0)])
def test_gqa_decode_quant_matches_the_reference(window, softcap):
    """20 teacher-forced steps into a linear cache and a ring of 8 (the
    writes wrap twice), GQA 2x with qkv bias; one case with a softcap.
    Equal within MODEL_TOL at every step whose int8 rows both sides
    share (``same_quant_rows``); at most a few steps have a row on a
    rounding boundary."""
    d = 128
    spec = quant_spec(window, softcap)
    ours, theirs = crossed(JL.init_gqa, d, spec, jnp.float32)
    ours = {k: v + 0.01 if k.startswith("b") else v
            for k, v in ours.items()}
    theirs = {k: v + 0.01 if k.startswith("b") else v
              for k, v in theirs.items()}
    jcache = JL.init_gqa_cache(spec, 2, 20, jnp.float32, quant=True)
    cache = L.init_gqa_cache(spec, 2, 20, torch.float32, "cpu", quant=True)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (tuple(v.shape), getattr(torch, str(v.dtype)))
        for k, v in jcache.items()}
    step = jax.jit(lambda c, x: JL.gqa_decode_quant(theirs, spec, x, c))
    xs = normal(31, (20, 2, 1, d))
    compared = 0
    for i in range(20):
        want, jcache = step(jcache, jnp.asarray(xs[i]))
        got, cache = L.gqa_decode_quant(ours, spec, t(xs[i]), cache)
        if same_quant_rows(cache, jcache):
            model_close(got, want)
            compared += 1
    assert compared >= 17, compared
    assert np.array_equal(cache["len"].numpy(), np.asarray(jcache["len"]))


# -- MLA ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",   # no q-LoRA
                                  "deepseek-v3-671b"])      # q-LoRA 48
def test_mla_forward_and_absorbed_decode_match_the_reference(arch):
    cfg = configs.get_smoke_config(arch)
    spec = cfg.blocks[0].attn
    assert spec.kind == "mla" and bool(spec.q_lora_rank) == ("v3" in arch)
    ours, theirs = crossed(JL.init_mla, cfg.d_model, spec, jnp.float32)
    b, s = 2, 40
    x = normal(32, (b, s, cfg.d_model))
    pos = np.arange(s)[None].repeat(b, 0)
    want = JL.mla_forward(theirs, spec, jnp.asarray(x), jnp.asarray(pos))
    got = L.mla_forward(ours, spec, t(x), t(pos))
    model_close(got, want)

    jcache = JL.init_mla_cache(spec, b, s, jnp.float32)
    cache = L.init_mla_cache(spec, b, s, torch.float32, "cpu")
    step = jax.jit(lambda c, xi: JL.mla_decode(theirs, spec, xi, c))
    for i in range(s):
        wd, jcache = step(jcache, jnp.asarray(x[:, i:i + 1]))
        gd, cache = L.mla_decode(ours, spec, t(x[:, i:i + 1]), cache)
        model_close(gd, wd)
        model_close(gd, want[:, i:i + 1])  # absorbed == materialized
    model_close(cache["ckv"], jcache["ckv"])
    model_close(cache["krope"], jcache["krope"])


# -- MoE ----------------------------------------------------------------------

def moe_case(arch, b, s, capacity_factor, seed):
    """A DeepSeek smoke MoE spec and crossed params whose router (and the
    sigmoid router's bias) lie on dyadic grids, and inputs x on a 2^-4
    grid in [-2, 2]: each router logit sums 128 products on a 2^-14 grid,
    each below 1 in magnitude, so every partial sum is a multiple of
    2^-14 below 2^7 (fewer than 2^21 units): exact in float32."""
    cfg = configs.get_smoke_config(arch)
    spec = dataclasses.replace(cfg.blocks[1].ffn,
                               capacity_factor=capacity_factor)
    _, theirs = crossed(JL.init_moe_ffn, cfg.d_model, spec, jnp.float32)
    theirs = dict(theirs)
    theirs["router"] = jnp.round(theirs["router"] * 1024) / 1024
    if spec.router == "sigmoid":
        theirs["router_bias"] = jnp.asarray(
            (np.arange(spec.n_experts) % 3 - 1) / 16, jnp.float32)
    ours = jax.tree.map(t, theirs)
    x = np.clip(np.round(normal(seed, (b, s, cfg.d_model)) * 16) / 16, -2, 2)
    return spec, ours, theirs, x


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",   # softmax, 2 shared
                                  "deepseek-v3-671b"])      # sigmoid + bias
@pytest.mark.parametrize("b,s,capacity_factor", [
    (2, 48, 1.25),      # t * k = 192 <= 4096: dropless, cap = t
    (2, 1100, 1.25),    # t * k = 4400 > 4096: cap = 688
    (2, 1100, 0.5),     # cap = 275: many dropped slots
])
def test_moe_ffn_matches_the_reference(arch, b, s, capacity_factor):
    spec, ours, theirs, x = moe_case(arch, b, s, capacity_factor, 33)
    want, jaux = JL.moe_ffn(theirs, spec, jnp.asarray(x))
    got, aux = L.moe_ffn(ours, spec, t(x))
    model_close(got, want)
    assert sorted(aux) == sorted(jaux)
    assert np.array_equal(aux["expert_counts"].numpy(),
                          np.asarray(jaux["expert_counts"]))
    if "lb_loss" in jaux:
        np.testing.assert_allclose(aux["lb_loss"].item(),
                                   float(jaux["lb_loss"]), rtol=1e-5)
    t_, k = b * s, spec.top_k
    cap = L.moe_capacity(t_, spec)
    assert cap == (t_ if t_ * k <= 4096 else int(np.ceil(
        t_ * k / spec.n_experts * capacity_factor)))
    dropped = int(torch.clamp_min(aux["expert_counts"] - cap, 0).sum())
    if capacity_factor == 0.5:
        assert dropped > 0
    if t_ * k <= 4096:
        assert dropped == 0


def test_moe_selection_breaks_ties_to_the_lower_expert():
    """Planted ties in the scores: the port's top-k equals
    jax.lax.top_k's, lower index first."""
    rng = np.random.default_rng(34)
    scores = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
    got_v, got_i = L.top_k_stable(t(scores), 5)
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert np.array_equal(got_v.numpy(), np.asarray(want_v))


def test_moe_combine_is_independent_of_the_run():
    spec, ours, _, x = moe_case("deepseek-v2-lite-16b", 2, 1100, 0.5, 35)
    y1, _ = L.moe_ffn(ours, spec, t(x))
    y2, _ = L.moe_ffn(ours, spec, t(x))
    assert torch.equal(y1, y2)


def test_moe_under_sharding_rules_matches_the_local_path():
    """``moe_ffn(rules=)`` over a (data 1, model 2) mesh of CPU members
    takes the expert-parallel path (two all-to-alls recorded), and at a
    capacity where nothing drops (cf = E) it equals the local path within
    1e-5 with the same counts (the reference's contract is held in
    tests/test_torch_lm_sharded.py)."""
    from repro_torch.distributed.collectives import record_collectives
    from repro_torch.launch.mesh import make_rules, make_test_mesh
    spec, ours, _, x = moe_case("deepseek-v3-671b", 1, 4, 1.25, 36)
    spec = dataclasses.replace(spec, capacity_factor=float(spec.n_experts))
    rules = make_rules(make_test_mesh((1, 2), devices="cpu"))
    with record_collectives() as ops:
        y, aux = L.moe_ffn(ours, spec, t(x), rules=rules)
    assert [op.kind for op in ops] == ["all-to-all", "all-to-all",
                                       "all-reduce"]
    y0, aux0 = L.moe_ffn(ours, spec, t(x))
    torch.testing.assert_close(y, y0, rtol=1e-5, atol=1e-5)
    assert torch.equal(aux["expert_counts"], aux0["expert_counts"])


def test_deepseek_params_cross_in_bfloat16_bit_for_bit():
    """bf16 leaves cross bit for bit; the float32 router and router bias
    stay float32."""
    kw = dict(param_dtype="bfloat16", activation_dtype="bfloat16")
    jcfg = jax_configs.get_smoke_config("deepseek-v3-671b", **kw)
    cfg = configs.get_smoke_config("deepseek-v3-671b", **kw)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg)[0])(
        jax.random.key(0))
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    ffn, jffn = params["groups"][1]["ffn"], jparams["groups"][1]["ffn"]
    assert ffn["router"].dtype == ffn["router_bias"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert np.array_equal(ffn["w_gate"].view(torch.int16).numpy(),
                          np.asarray(jffn["w_gate"]).view(np.int16))
    assert np.array_equal(ffn["router"].numpy(), np.asarray(jffn["router"]))
    mtp = params["mtp"]["block"]["attn"]["wq_b"]
    assert np.array_equal(mtp.view(torch.int16).numpy(), np.asarray(
        jparams["mtp"]["block"]["attn"]["wq_b"]).view(np.int16))
    with torch.inference_mode():
        logits, aux = T.forward(params, cfg, {"tokens": t(np.arange(
            24, dtype=np.int32).reshape(2, 12))})
    assert logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()
    assert aux["expert_counts_g1"].sum().item() == 2 * 24 * 2  # layers*T*k


# -- cross-attention ----------------------------------------------------------

def test_cross_attn_forward_matches_the_reference():
    cfg = configs.get_smoke_config("musicgen-medium")
    spec = cfg.blocks[0].attn
    ours, theirs = crossed(JL.init_cross_attn, cfg.d_model, spec,
                           jnp.float32)
    x = normal(37, (2, 20, cfg.d_model))
    cond = normal(38, (2, cfg.n_cond_tokens, cfg.d_model))
    want = JL.cross_attn_forward(theirs, spec, jnp.asarray(x),
                                 jnp.asarray(cond))
    model_close(L.cross_attn_forward(ours, spec, t(x), t(cond)), want)


# -- decode softcap -----------------------------------------------------------

@pytest.mark.parametrize("window", [None, 8])
def test_decode_softcap_through_the_plain_flash_decode(window):
    """gqa_decode with a softcap (the plain flash_decode on the CPU)
    against the reference's gqa_decode (attention_decode's softcap), 20
    steps, GQA 2x, a ring of 8 or a linear cache; the cap bites (5.0 on
    scores of a few units)."""
    cfg = configs.get_smoke_config("gemma3-12b")
    spec = dataclasses.replace(cfg.blocks[0].attn, window=window,
                               logit_softcap=5.0)
    ours, theirs = crossed(JL.init_gqa, cfg.d_model, spec, jnp.float32)
    ours = {k: v * 4 for k, v in ours.items()}
    theirs = {k: v * 4 for k, v in theirs.items()}
    jcache = JL.init_gqa_cache(spec, 2, 20, jnp.float32)
    cache = L.init_gqa_cache(spec, 2, 20, torch.float32, "cpu")
    step = jax.jit(lambda c, x: JL.gqa_decode(theirs, spec, x, c))
    xs = normal(39, (20, 2, 1, cfg.d_model))
    ops.reset_dispatch()
    capped = 0.0
    for i in range(20):
        want, jcache = step(jcache, jnp.asarray(xs[i]))
        got, cache = L.gqa_decode(ours, spec, t(xs[i]), cache)
        model_close(got, want)
        uncapped, _ = L.gqa_decode(
            ours, dataclasses.replace(spec, logit_softcap=None), t(xs[i]),
            {k: v.clone() for k, v in cache.items()} | {
                "len": cache["len"] - 1})
        capped = max(capped, (uncapped - got).abs().max().item())
    assert capped > 1e-2  # the cap changes the output
    assert ops.dispatch_breakdown()["flash_decode"] == {"torch-ref": 40}
