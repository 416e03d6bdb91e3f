"""The reverse mix's training in the port against the JAX package's, on
the CPU: ``loss_fn``, every gradient leaf and one ``make_train_step``
past the warm-up (from a non-zero AdamW state, with fp32 and with bf16
moments) at the smoke configs of mamba2-130m, hymba-1.5b, deepseek-v3-671b
(MLA, the sigmoid MoE with its float32 router and bias, the MTP block)
and musicgen-medium (audio frames, cross-attention, codebook heads), all
with bfloat16 params and float32 activations.

The params are the reference's (crossed as in
tests/test_torch_lm_reverse.py). A gradient has its param's dtype on both
sides: bfloat16, float32 for the routers. Each product's float32 result
is the same number on both sides to within float32 rounding, but a
bfloat16 gradient rounds it, and an element near a rounding boundary may
land one bfloat16 step apart (a weight used more than once, the tied
embedding, sums its cotangents in bfloat16, as the reference's). So a
bfloat16 leaf is held to one bfloat16 step at the leaf's max|reference|
(``bf16_step``), with at least ``EQUAL_SHARE`` of its elements bit-equal;
measured: the worst gradient leaf exactly one step (mamba2's, 1 of 128
elements apart), the lowest share 99.2 %; the step's params at most one
step, the lowest share 97.5 % (a hymba leaf). A float32 leaf (the routers) is held to
``MODEL_TOL`` x its max|reference| (grads) and ``STEP_TOL`` x the
reference's largest change of the leaf (the step), as
tests/test_torch_lm_train.py. The loss within 1e-5 relative (measured
1.5e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.distributed import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import (  # noqa: E402
    AdamWConfig as JAdamWConfig, ScheduleConfig as JScheduleConfig,
    make_schedule as j_make_schedule,
)
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, make_schedule,
)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from test_torch_lm_reverse import bf16_step, crossed, name  # noqa: E402
from test_torch_lm_train import batch_of, leaves, opt_state_np  # noqa: E402

ARCHS = ("mamba2-130m", "hymba-1.5b", "deepseek-v3-671b", "musicgen-medium")
MOMENTS = ("fp32", "bf16")
LOSS_TOL = 1e-5
MODEL_TOL = 1e-4
STEP_TOL = 1e-3
EQUAL_SHARE = 0.95
SCHEDULE = dict(warmup_steps=2, total_steps=10)
STEP = 5  # past the warm-up: the schedule's lr is > 0


def state_of(pnp, moments):
    """A non-zero AdamW state (numpy, the reference's layout), its moments
    cast to bfloat16 for ``moments == "bf16"``."""
    state = opt_state_np(pnp, 2)
    if moments == "bf16":
        cast = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))  # noqa
        state = dict(state, m=jax.tree.map(cast, state["m"]),
                     v=jax.tree.map(cast, state["v"]))
    return state


_CASES = {}


def case(arch):
    """The reference's loss, grads and its train step from each moments'
    state, on the crossed params and a numpy batch (one jit)."""
    if arch in _CASES:
        return _CASES[arch]
    cfg, params, jcfg, jparams = crossed(arch)
    pnp = jax.tree.map(np.asarray, jparams)
    batch = batch_of(cfg, 1)
    states = {m: state_of(pnp, m) for m in MOMENTS}
    jsteps = {m: JS.make_train_step(
        jcfg, JAdamWConfig(state_dtype=m),
        j_make_schedule(JScheduleConfig(**SCHEDULE))) for m in MOMENTS}

    def both(p, sts, b):
        (loss, metrics), grads = jax.value_and_grad(
            JT.loss_fn, has_aux=True)(p, jcfg, b)
        return loss, grads, {m: jsteps[m](p, sts[m], b, jnp.asarray(
            STEP, jnp.int32)) for m in MOMENTS}

    want = jax.jit(both)(jparams, jax.tree.map(jnp.asarray, states),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    _CASES[arch] = (cfg, params, batch, states,
                    jax.tree.map(np.asarray, want))
    return _CASES[arch]


def port_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def leaf_close(got, want, f32_scale, f32_tol, what):
    """``got`` (a port leaf) against ``want`` (the reference's) in the
    same dtype: a bfloat16 leaf within one bfloat16 step at max|want| and
    mostly bit-equal, a float32 leaf within ``f32_tol * f32_scale``.
    Returns (the error in bfloat16 steps, the share equal) of a bfloat16
    leaf, else None."""
    assert name(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    g, w = got.float().numpy(), want.astype(np.float32)
    assert g.shape == w.shape, what
    err = np.abs(g - w).max()
    if got.dtype == torch.float32:
        assert err <= f32_tol * f32_scale, (what, err, f32_scale)
        return None
    unit = bf16_step(np.abs(w).max())
    share = float(np.mean(g == w))
    assert err <= unit and share >= EQUAL_SHARE, (what, err, unit, share)
    return (err / unit if unit else 0.0), share


def moment_bound(key, jgrad, want, moments) -> float:
    """How far a moment leaf may lie from the reference's when the
    gradient that fed it lies within one bfloat16 step (``unit``, at its
    leaf's max|g|, clipped by <= 1): m moves by (1 - b1) x the gradient's
    error, v by (1 - b2) x (2 max|g| + unit) x unit; plus float32 rounding
    (``MODEL_TOL`` at max|moment|) and, for bf16 moments, one bfloat16
    step at max|moment|."""
    opt = AdamWConfig()
    g_max = float(np.abs(jgrad.astype(np.float32)).max())
    unit = bf16_step(g_max)
    if key == "m":
        bound = (1 - opt.b1) * unit
    else:
        bound = (1 - opt.b2) * (2 * g_max + unit) * unit
    top = float(np.abs(want).max())
    bound += MODEL_TOL * top
    if moments == "bf16":
        bound += bf16_step(top)
    return bound


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    """The loss (float32) and every gradient leaf in its param's dtype:
    bfloat16, float32 for the routers (the sigmoid router's bias gets
    none, as the reference's zeros)."""
    cfg, params, batch, _, (jloss, jgrads, _) = case(arch)
    loss, _, grads = steps.loss_and_grads(params, cfg, port_batch(batch))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    want = jax.tree.leaves(jgrads)
    got = leaves(grads)
    assert len(got) == len(want)
    bf16 = [leaf_close(g, w, max(np.abs(w).max(), 1e-30), MODEL_TOL, i)
            for i, (g, w) in enumerate(zip(got, want))]
    assert any(r is not None for r in bf16)


@pytest.mark.parametrize("moments", MOMENTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, moments):
    """One step at lr > 0 from a non-zero state: the params stay bfloat16
    (the routers float32) and the leaves the reference's step moves move,
    the moments keep their dtype, each leaf of the new params and moments
    against the reference's step (``leaf_close``, ``moment_bound``)."""
    cfg, params, batch, states, (_, _, jsteps) = case(arch)
    jp, jopt, jm = jsteps[moments]
    step = steps.make_train_step(cfg, AdamWConfig(state_dtype=moments),
                                 make_schedule(ScheduleConfig(**SCHEDULE)))
    opt = convert.adamw_state_from_numpy(states[moments], params)
    new, new_opt, metrics = step(params, opt, port_batch(batch), STEP)
    moved = [np.abs(w.astype(np.float32) - p.float().numpy()).max()
             for w, p in zip(jax.tree.leaves(jp), leaves(params))]
    for i, (g, w, p) in enumerate(zip(leaves(new), jax.tree.leaves(jp),
                                      leaves(params))):
        assert g.dtype == p.dtype
        leaf_close(g, w, moved[i], STEP_TOL, ("params", i))
    # A bfloat16 leaf moves where the update passes half its step: the
    # same leaves move as in the reference's step (not d_skip's ones).
    moves = [not torch.equal(g, p) for g, p in zip(leaves(new),
                                                   leaves(params))]
    assert moves == [bool(m > 0) for m in moved] and sum(moves) > 1
    dt = torch.float32 if moments == "fp32" else torch.bfloat16
    jgrads = jax.tree.leaves(case(arch)[4][1])
    for key in ("m", "v"):
        got = leaves(new_opt[key])
        assert {x.dtype for x in got} == {dt}
        for i, (g, w) in enumerate(zip(got, jax.tree.leaves(jopt[key]))):
            w = w.astype(np.float32)
            err = np.abs(g.float().numpy() - w).max()
            bound = moment_bound(key, jgrads[i], w, moments)
            assert err <= bound, (key, i, err, bound)
    assert int(new_opt["step"]) == int(jopt["step"]) == STEP + 1
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(
        float(jm["loss"]))
    assert {x.dtype for x in tree_leaves(new)} <= {torch.bfloat16,
                                                   torch.float32}
