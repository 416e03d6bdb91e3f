"""Mixed precision in the port's LM stack against the JAX package's, on the
CPU: float32 params with bfloat16 activations, every registered
architecture's smoke config made mixed.

Where the reference runs a mixed config (a stack of SSM blocks with no
FFN or cross-attention: mamba2-130m), the port is held to it: ``forward``
logits, teacher-forced ``decode_step`` logits with the caches' dtypes
after every step, ``loss_fn`` and every gradient leaf, one
``make_train_step`` past the warm-up (float32 params, fp32 moments, the
params moved), greedy ``generate``, the same stack with a vision frontend
or an MTP block (the other mixed products), and a mixed train state that
the reference checkpoints and the port restores bit for bit. Where the
reference's layer scan raises ``TypeError`` (its bfloat16 carry comes back
float32), the port raises ``NotImplementedError`` at every entry point.
The reverse mix (bfloat16 params, float32 activations) runs on every
architecture in both packages; tests/test_torch_lm_reverse*.py hold the
port to the reference there.

The reference's params (``T.init_params(jax.random.key(0), cfg)``, float32)
cross through ``convert.lm_params_from_numpy``; tokens, targets and a
non-zero AdamW state come from numpy.

Tolerances are set by a bf16 yardstick: the port's own float32 run of the
same params (``param_dtype = activation_dtype = float32``), whose distance
from the port's mixed run is what rounding the activations to bfloat16
costs. The logits, each within that distance of the reference and within
one bfloat16 step at max|logit| (2^-7 x max|reference|), with at least
95 % of the forward's logits equal bit for bit (measured: forward 0.0156
of 3.94 against a yardstick of 0.0339, 99.5 % equal; decode 6e-8 against
0.0324); the loss within 1e-5 relative (measured 2e-7); each gradient leaf
and each leaf of the step's params within half the yardstick of that leaf
(measured at most 0.22 of it: the embedding's gradient, 3.2e-3 of its
max|leaf| against 1.4e-2).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import (  # noqa: E402
    AdamWConfig as JAdamWConfig, ScheduleConfig as JScheduleConfig,
    make_schedule as j_make_schedule,
)
from repro_torch import configs, convert, generator  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, make_schedule,
)
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

MIXED = dict(param_dtype="float32", activation_dtype="bfloat16")
RUNS = ("mamba2-130m",)  # the archs whose mixed config the reference runs
LOSS_TOL = 1e-5
EQUAL_SHARE = 0.95
LEAF_SHARE = 0.5
B, S = 2, 40
SCHEDULE = dict(warmup_steps=2, total_steps=10)
STEP = 5  # past the warm-up: the schedule's lr is > 0


def mixed(arch, pkg=configs):
    return pkg.get_smoke_config(arch, **MIXED)


def float32(arch):
    return configs.get_smoke_config(arch, param_dtype="float32",
                                    activation_dtype="float32")


def abstract_batch(cfg, s):
    """The reference's inputs for ``cfg`` as ShapeDtypeStructs."""
    sds = jax.ShapeDtypeStruct
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": sds((B, s, cfg.d_model), jnp.float32)}
    batch = {"tokens": sds((B, s), jnp.int32)}
    if cfg.frontend == "vision_patches" and s > 1:
        batch["patch_feats"] = sds((B, cfg.n_patches, 1024), jnp.float32)
    return batch


def reference_raises(cfg):
    """(forward, decode_step): for each, the reference's TypeError message,
    or None where it runs. Traced with ``jax.eval_shape``: the layer
    scan's carry check is a trace-time check, so nothing is computed."""
    params = jax.eval_shape(lambda k: JT.init_params(k, cfg)[0],
                            jax.random.key(0))

    def decode(p, b):
        return JT.decode_step(p, cfg, b, JT.init_cache(cfg, B, 8))

    out = []
    for fn, s in ((lambda p, b: JT.forward(p, cfg, b), 8), (decode, 1)):
        try:
            jax.eval_shape(fn, params, abstract_batch(cfg, s))
            out.append(None)
        except TypeError as e:
            out.append(str(e))
    return out


@pytest.mark.parametrize("arch", configs.list_archs())
def test_mixed_configs_run_exactly_where_the_reference_runs(arch):
    """The reference runs a mixed config where RUNS says, and raises its
    scan-carry TypeError in forward and decode elsewhere; the port runs
    the same configs and refuses the rest at every entry point."""
    fwd, dec = reference_raises(mixed(arch, jax_configs))
    cfg = mixed(arch)
    if arch in RUNS:
        assert fwd is None and dec is None
        T.check_supported(cfg)
        return
    for msg in (fwd, dec):
        assert msg is not None and "carry" in msg and "bfloat16" in msg
    with pytest.raises(NotImplementedError, match="TypeError"):
        T.check_supported(cfg)
    params32 = T.init_params(generator(0, "cpu"), float32(arch),
                             device="cpu")
    caches32 = T.init_cache(float32(arch), B, 8, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int64)
    for call in (
            lambda: T.init_params(generator(0, "cpu"), cfg, device="cpu"),
            lambda: T.init_cache(cfg, B, 8, device="cpu"),
            lambda: convert.lm_params_from_numpy(
                tree_map(lambda x: x.numpy(), params32), cfg, device="cpu"),
            lambda: T.embed_inputs(params32, cfg, {"tokens": tok}),
            lambda: T.decode_step(params32, cfg, {"tokens": tok},
                                  caches32)):
        with pytest.raises(NotImplementedError, match="bfloat16"):
            call()


@pytest.mark.parametrize("arch", configs.list_archs())
def test_the_reverse_mix_runs_where_the_reference_runs(arch):
    """bfloat16 params with float32 activations: the reference runs
    forward and decode on every architecture (every product promotes to
    float32), and the port lets the config through
    (tests/test_torch_lm_reverse.py holds it to the reference)."""
    kw = dict(param_dtype="bfloat16", activation_dtype="float32")
    assert reference_raises(
        jax_configs.get_smoke_config(arch, **kw)) == [None, None]
    T.check_supported(configs.get_smoke_config(arch, **kw))


# -- where the reference runs: the port held to it ---------------------------

_CASES = {}


def case(arch):
    """The reference's params (numpy), the port's copy, numpy tokens and
    targets, and the reference's forward, loss, grads and train step."""
    if arch in _CASES:
        return _CASES[arch]
    jcfg = mixed(arch, jax_configs)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg)[0])(
        jax.random.key(0))
    pnp = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    tgt = rng.integers(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    state = opt_state_np(pnp, 2)
    jbatch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)}
    logits, _ = JT.forward(jparams, jcfg, jbatch)
    (loss, _), grads = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jparams, jcfg, jbatch)
    jstep = JS.make_train_step(jcfg, JAdamWConfig(),
                               j_make_schedule(JScheduleConfig(**SCHEDULE)))
    new, jopt, jm = jstep(jparams, jax.tree.map(jnp.asarray, state), jbatch,
                          jnp.asarray(STEP, jnp.int32))
    out = dict(jcfg=jcfg, jparams=jparams, pnp=pnp, tok=tok, tgt=tgt,
               state=state, logits=np.asarray(logits.astype(jnp.float32)),
               loss=float(loss), grads=jax.tree.leaves(grads),
               new=jax.tree.leaves(new), jopt=jopt, jm=jm,
               params=convert.lm_params_from_numpy(pnp, mixed(arch),
                                                   device="cpu"))
    _CASES[arch] = out
    return out


def opt_state_np(params, seed):
    """A non-zero AdamW state (numpy leaves, the reference's layout) five
    steps in: m ~ N(0, 1e-3^2), v ~ U(0.5, 1) x 1e-6."""
    rng = np.random.default_rng(seed)

    def leaf(make):
        return jax.tree.map(lambda p: make(p.shape).astype(np.float32),
                            params)

    return {"m": leaf(lambda s: rng.normal(size=s) * 1e-3),
            "v": leaf(lambda s: rng.uniform(0.5, 1.0, size=s) * 1e-6),
            "step": np.asarray(STEP, np.int32)}


def leaves(tree) -> list:
    """A port tree's leaves in the reference's order (dict keys sorted, as
    ``jax.tree.leaves`` walks them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tokens(c):
    return {"tokens": torch.tensor(c["tok"]),
            "targets": torch.tensor(c["tgt"])}


def logits_close(got, want, yardstick):
    """``got`` (the port's mixed logits) against the reference's: within
    the bf16 yardstick and one bfloat16 step at max|reference|."""
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= yardstick, (err, yardstick)
    assert err <= 2.0 ** -7 * np.abs(want).max(), err


@pytest.mark.parametrize("arch", RUNS)
def test_forward_matches_the_reference(arch):
    c = case(arch)
    got, _ = T.forward(c["params"], mixed(arch), tokens(c))
    f32, _ = T.forward(c["params"], float32(arch), tokens(c))
    logits_close(got, c["logits"],
                 np.abs(got.float().numpy() - f32.numpy()).max())
    assert np.mean(got.float().numpy() == c["logits"]) >= EQUAL_SHARE


@pytest.mark.parametrize("arch", RUNS)
def test_decode_matches_the_reference_with_its_cache_dtypes(arch):
    """Teacher-forced decode over 12 tokens: the logits after every step,
    and the caches' dtypes at init (bfloat16) and after each step (the
    conv window float32 from the first step on, the state bfloat16), as
    the reference's."""
    c = case(arch)
    cfg, jcfg = mixed(arch), c["jcfg"]
    jc = JT.init_cache(jcfg, B, S)
    pc = T.init_cache(cfg, B, S, device="cpu")
    pc32 = T.init_cache(float32(arch), B, S, device="cpu")

    def dtypes(tree, name):
        return [{k: name(v.dtype) for k, v in layer["ssm"].items()}
                for layer in tree]

    def jdtypes(jc):
        return [{k: str(v.dtype) for k, v in g["ssm"].items()}
                for g in jc for _ in range(g["ssm"]["len"].shape[0])]

    def port(pc):
        return dtypes([layer for g in pc for layer in g],
                      lambda d: str(d).removeprefix("torch."))

    assert port(pc) == jdtypes(jc)
    assert {d["conv"] for d in port(pc)} == {"bfloat16"}
    for t in range(12):
        tok = c["tok"][:, t:t + 1]
        want, jc = JT.decode_step(c["jparams"], jcfg,
                                  {"tokens": jnp.asarray(tok)}, jc)
        got, pc = T.decode_step(c["params"], cfg,
                                {"tokens": torch.tensor(tok)}, pc)
        f32, pc32 = T.decode_step(c["params"], float32(arch),
                                  {"tokens": torch.tensor(tok)}, pc32)
        logits_close(got, np.asarray(want.astype(jnp.float32)),
                     np.abs(got.float().numpy() - f32.numpy()).max())
        assert port(pc) == jdtypes(jc)
        assert {(d["conv"], d["state"]) for d in port(pc)} == {
            ("float32", "bfloat16")}


def leaves_within_yardstick(got, got32, want, scale):
    """Each leaf of ``got`` within LEAF_SHARE x its bf16 yardstick
    (max|got - got32|) of ``want``; returns the worst share."""
    worst = 0.0
    for i, (g, g32, w) in enumerate(zip(leaves(got), leaves(got32), want)):
        assert g.dtype == torch.float32 and g.shape == w.shape, i
        g, w = g.numpy(), np.asarray(w)
        err = np.abs(g - w).max()
        yard = np.abs(g - g32.numpy()).max()
        assert err <= LEAF_SHARE * yard, (i, err, yard, scale(i, w))
        worst = max(worst, err / yard)
    return worst


@pytest.mark.parametrize("arch", RUNS)
def test_loss_and_grads_match_the_reference(arch):
    """The loss, and every gradient leaf (float32, as its param); the
    remat of each layer changes no number."""
    c = case(arch)
    loss, _, grads = steps.loss_and_grads(c["params"], mixed(arch),
                                          tokens(c))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - c["loss"]) <= LOSS_TOL * abs(c["loss"])
    _, _, grads32 = steps.loss_and_grads(c["params"], float32(arch),
                                         tokens(c))
    leaves_within_yardstick(grads, grads32, c["grads"],
                            lambda i, w: np.abs(w).max())
    remat = dataclasses.replace(mixed(arch), remat=True)
    loss_r, _, grads_r = steps.loss_and_grads(c["params"], remat, tokens(c))
    assert torch.equal(loss_r, loss)
    for a, b in zip(leaves(grads_r), leaves(grads)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", RUNS)
def test_train_step_matches_the_reference(arch):
    """One step at lr > 0 from a non-zero AdamW state: the params stay
    float32 and move, the moments stay fp32, each leaf within half its
    yardstick of the reference's step."""
    c = case(arch)
    sched = make_schedule(ScheduleConfig(**SCHEDULE))
    assert float(sched(STEP)) > 0
    outs = []
    for cfg in (mixed(arch), float32(arch)):
        step = steps.make_train_step(cfg, AdamWConfig(), sched)
        outs.append(step(c["params"], convert.adamw_state_from_numpy(
            c["state"], c["params"]), tokens(c), STEP))
    (new, opt, metrics), (new32, _, _) = outs
    leaves_within_yardstick(new, new32, c["new"], None)
    for a, p in zip(leaves(new), leaves(c["params"])):
        assert not torch.equal(a, p)
    for tree in (opt["m"], opt["v"]):
        assert {x.dtype for x in tree_leaves(tree)} == {torch.float32}
    assert int(opt["step"]) == int(c["jopt"]["step"]) == STEP + 1
    assert abs(float(metrics["loss"]) - float(c["jm"]["loss"])) <= (
        LOSS_TOL * abs(float(c["jm"]["loss"])))


@pytest.mark.parametrize("arch", RUNS)
def test_generate_matches_the_reference(arch):
    """Greedy serving of the mixed config: 8 prompt tokens and 8 new ones,
    token for token the reference's ``generate``."""
    c = case(arch)
    prompts = c["tok"][:, :8]
    want = jserve.generate(c["jcfg"], c["jparams"], jnp.asarray(prompts), 8)
    got = serve.generate(mixed(arch), c["params"],
                         torch.tensor(prompts, dtype=torch.int32), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# The mixed products outside the SSM layers, on the same SSM stack: a vision
# frontend's patch projection and the MTP block's input projection.
VARIANTS = {"vision_patches": dict(frontend="vision_patches", n_patches=4),
            "mtp": dict(mtp_depth=1)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_the_ssm_stack_with_a_frontend_or_mtp_matches_the_reference(variant):
    """mamba2's smoke stack with a vision frontend or an MTP block, made
    mixed (the reference runs both): the forward logits as in
    test_forward_matches_the_reference, the loss within its own bf16
    yardstick (|mixed - float32| of the port's loss). The patch
    projection sums 1,024 float32 products in another order than the
    reference (1.7e-6 apart), which flips bf16 roundings downstream:
    measured 78 % of the logits equal, the loss 4.1e-4 from the
    reference's against a yardstick of 1.5e-3; MTP 9.5e-7 against
    3.6e-4."""
    kw = VARIANTS[variant]
    jcfg = dataclasses.replace(mixed("mamba2-130m", jax_configs), **kw)
    cfg = dataclasses.replace(mixed("mamba2-130m"), **kw)
    cfg32 = dataclasses.replace(float32("mamba2-130m"), **kw)
    jparams = jax.jit(lambda k: JT.init_params(k, jcfg)[0])(
        jax.random.key(0))
    params = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          cfg, device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(B, 24)).astype(
        np.int32) for k in ("tokens", "targets")}
    if cfg.frontend == "vision_patches":
        batch["patch_feats"] = rng.normal(
            size=(B, cfg.n_patches, T.VIT_DIM)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    want, _ = JT.forward(jparams, jcfg, jbatch)
    got, _ = T.forward(params, cfg, tbatch)
    f32, _ = T.forward(params, cfg32, tbatch)
    logits_close(got, np.asarray(want.astype(jnp.float32)),
                 np.abs(got.float().numpy() - f32.numpy()).max())
    jloss, jm = JT.loss_fn(jparams, jcfg, jbatch)
    loss, m = T.loss_fn(params, cfg, tbatch)
    loss32, _ = T.loss_fn(params, cfg32, tbatch)
    assert sorted(m) == sorted(jm)
    assert abs(float(loss) - float(jloss)) <= abs(float(loss)
                                                  - float(loss32))


# -- a mixed train state across the two packages' checkpoints ----------------

ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A mixed mamba2 train state after one reference step at lr > 0 (float32
    params, fp32 moments), saved by the reference's manager."""
    jcfg = mixed(ARCH, jax_configs)
    params, opt, _ = JS.init_train_state(jax.random.key(0), jcfg,
                                         JAdamWConfig())
    jstep = JS.make_train_step(jcfg, JAdamWConfig(),
                               j_make_schedule(JScheduleConfig(**SCHEDULE)))
    rng = np.random.default_rng(3)
    batch = {k: jnp.asarray(rng.integers(0, jcfg.vocab_size, size=(B, S)),
                            jnp.int32) for k in ("tokens", "targets")}
    params, opt, _ = jstep(params, opt, batch, jnp.asarray(STEP, jnp.int32))
    tree = {"params": params, "opt": opt}
    d = str(tmp_path_factory.mktemp("ckpt"))
    jmanager.CheckpointManager(jmanager.CheckpointConfig(d)).save(STEP + 1,
                                                                  tree)
    return d, jax.tree.map(np.asarray, tree)


def restored_and_in_memory(saved):
    d, want = saved
    cfg = mixed(ARCH)
    params = T.init_params(generator(1, "cpu"), cfg, device="cpu")
    template = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    step, tree, _ = manager.CheckpointManager(
        manager.CheckpointConfig(d)).restore(template)
    assert step == STEP + 1
    mem = convert.lm_params_from_numpy(want["params"], cfg, device="cpu")
    return tree, mem, convert.adamw_state_from_numpy(want["opt"], mem)


def pairs(a, b) -> list:
    """(a leaf, b leaf) by key: a restored checkpoint's dicts come back
    key-sorted, so trees are never zipped by leaf order."""
    if isinstance(a, dict):
        return [x for k in sorted(a) for x in pairs(a[k], b[k])]
    if isinstance(a, list):
        return [x for u, v in zip(a, b) for x in pairs(u, v)]
    return [(a, b)]


def test_mixed_train_state_restores_bit_for_bit(saved):
    tree, mem, opt = restored_and_in_memory(saved)
    got = pairs(tree["params"], mem) + pairs(tree["opt"]["m"], opt["m"]) \
        + pairs(tree["opt"]["v"], opt["v"])
    assert len(got) > 30
    for a, b in got:
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    assert int(tree["opt"]["step"]) == int(opt["step"]) == 1  # one update
    assert bool(opt["m"]["embed"].abs().max() > 0)


def test_a_mixed_step_from_the_restored_state_is_bit_identical(saved):
    tree, mem, opt = restored_and_in_memory(saved)
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, 512, size=(B, S)).astype(
        np.int32)) for k in ("tokens", "targets")}
    step_fn = steps.make_train_step(mixed(ARCH), AdamWConfig(),
                                    make_schedule(ScheduleConfig(**SCHEDULE)))
    (pa, oa, ma), (pb, ob, mb) = (step_fn(p, o, batch, STEP + 1)
                                  for p, o in ((tree["params"], tree["opt"]),
                                               (mem, opt)))
    assert torch.equal(ma["loss"], mb["loss"])
    for a, b in pairs(pa, pb) + pairs(oa["m"], ob["m"]) + pairs(oa["v"],
                                                                ob["v"]):
        assert torch.equal(a, b)
    assert any(not torch.equal(a, b) for a, b in pairs(pa, mem))
