"""The port's LM training step against the JAX package's, on the CPU:
``loss_fn`` and its metrics, the gradient of every float leaf and one
``make_train_step`` step, at the smoke configs of mamba2-130m and
hymba-1.5b (the SSD layers) and deepseek-v3 (MLA, the sigmoid MoE with
its aux-free router-bias update, the MTP loss; its step accumulates two
microbatches); tests/test_torch_lm_train_families.py runs the other
seven architectures through the same checks. Also: the reference's NaN
SSD gradient at chunk 256 and the port's finite one, and the
``ssd_chunk`` autograd Function's plumbing on the CPU.

The params come from the port's ``init_params`` (seed 0) and cross to the
reference as numpy; batches and a non-zero AdamW state are drawn with
numpy. All float32. Tolerances: the loss within 1e-5 relative; each grad
leaf within 1e-4 x max|reference leaf| (``MODEL_TOL``, as the forward
tests: sums in another order; the worst leaf measured is 7e-6); the
step's params within 1e-3 x the reference's largest change of the leaf
(AdamW divides each grad element by sqrt(v), which carries the grads'
1e-5 agreement into the update; the worst measured is 1e-4).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import SsmSpec as JSsmSpec  # noqa: E402
from repro.optim import (  # noqa: E402
    AdamWConfig as JAdamWConfig, ScheduleConfig as JScheduleConfig,
    make_schedule as j_make_schedule,
)
from repro_torch import configs, convert, generator  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import SsdChunk  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import SsmSpec  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, make_schedule,
)
from repro_torch.optim.adamw import tree_map  # noqa: E402

LOSS_TOL = 1e-5
MODEL_TOL = 1e-4
STEP_TOL = 1e-3
B = 2
SCHEDULE = dict(warmup_steps=2, total_steps=10)
STEP = 5  # the step the train step is called at: past the warm-up
ARCHS = ("mamba2-130m", "hymba-1.5b", "deepseek-v3-671b")


def grad_accum(arch):
    return 2 if arch == "deepseek-v3-671b" else 1


def batch_of(cfg, seed):
    """Numpy inputs and targets: S 72 where a window must switch the
    forward to its local path, 40 otherwise."""
    rng = np.random.default_rng(seed)
    windows = [b.attn.window for b in cfg.blocks
               if b.attn is not None and b.attn.window]
    s = 72 if windows else 40
    if cfg.frontend == "audio_frames":
        return {"frame_embeds": rng.normal(
                    size=(B, s, cfg.d_model)).astype(np.float32),
                "cond_embeds": rng.normal(
                    size=(B, cfg.n_cond_tokens, cfg.d_model)).astype(
                        np.float32),
                "targets": rng.integers(0, cfg.vocab_size, size=(
                    B, s, cfg.n_codebooks)).astype(np.int32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, s)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size,
                                     size=(B, s)).astype(np.int32)}
    if cfg.frontend == "vision_patches":
        batch["patch_feats"] = rng.normal(
            size=(B, cfg.n_patches, T.VIT_DIM)).astype(np.float32)
    return batch


def leaves(tree) -> list:
    """A port tree's leaves in the reference's order (dict keys sorted,
    as ``jax.tree.leaves`` walks them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def rebuild(like, it):
    """``like``'s structure over the leaves of ``it`` (``leaves`` order)."""
    if isinstance(like, dict):
        return {k: rebuild(like[k], it) for k in sorted(like)}
    if isinstance(like, list):
        return [rebuild(v, it) for v in like]
    return next(it)


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree.numpy())


def opt_state_np(params, seed):
    """A non-zero AdamW state (numpy leaves, the reference's layout)
    five steps in: m ~ N(0, 1e-3^2), v ~ U(0.5, 1) x 1e-6."""
    rng = np.random.default_rng(seed)

    def leaf(make):
        return tree_map(lambda p: make(p.shape).astype(np.float32), params)

    return {"m": leaf(lambda s: rng.normal(size=s) * 1e-3),
            "v": leaf(lambda s: rng.uniform(0.5, 1.0, size=s) * 1e-6),
            "step": np.asarray(STEP, np.int32)}


@functools.lru_cache(maxsize=None)
def case(arch):
    """The port's cfg, params, batch and state, and the reference's loss,
    metrics, grads and train step on the same operands (one jit)."""
    cfg = configs.get_smoke_config(arch)
    jcfg = jax_configs.get_smoke_config(arch)
    params = T.init_params(generator(0, "cpu"), cfg, device="cpu")
    batch = batch_of(cfg, 1)
    state = opt_state_np(params, 2)
    jstep = JS.make_train_step(jcfg, JAdamWConfig(),
                               j_make_schedule(JScheduleConfig(**SCHEDULE)),
                               grad_accum=grad_accum(arch))

    def both(p, st, b):
        (loss, metrics), grads = jax.value_and_grad(
            JT.loss_fn, has_aux=True)(p, jcfg, b)
        return loss, metrics, grads, jstep(p, st, b,
                                           jnp.asarray(STEP, jnp.int32))

    want = jax.jit(both)(to_jax(params), jax.tree.map(jnp.asarray, state),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    return cfg, params, batch, state, jax.tree.map(np.asarray, want)


def port_batch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def leaves_close(got, want, scale_of, tol, what):
    for i, (g, w) in enumerate(zip(leaves(got), jax.tree.leaves(want))):
        g = g.float().numpy()
        assert g.shape == w.shape, (what, i)
        scale = scale_of(i, w)
        err = np.abs(g - w.astype(np.float32)).max()
        assert err <= tol * scale, (what, i, err, scale)


def check_loss_and_metrics(arch):
    cfg, params, batch, _, (jloss, jmetrics, _, _) = case(arch)
    loss, metrics = T.loss_fn(params, cfg, port_batch(batch))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert sorted(metrics) == sorted(jmetrics)
    for k, v in jmetrics.items():
        if k.startswith("expert_counts"):
            np.testing.assert_array_equal(metrics[k].numpy(), v)
        else:
            assert abs(float(metrics[k]) - float(v)) <= LOSS_TOL * abs(
                float(v)), k


def check_grads(arch):
    """Every float leaf's gradient; autograd reaches every leaf the
    reference's gradient touches; remat changes no number."""
    cfg, params, batch, _, (_, _, jgrads, _) = case(arch)
    loss, _, grads = steps.loss_and_grads(params, cfg, port_batch(batch))
    leaves_close(grads, jgrads, lambda i, w: max(np.abs(w).max(), 1e-30),
                 MODEL_TOL, "grad")
    # The leaves autograd left unreached (None) are the reference's zero
    # gradients (a sigmoid router's selection bias).
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    with torch.enable_grad():
        raw = torch.autograd.grad(
            T.loss_fn(rebuild(params, iter(flat)), cfg,
                      port_batch(batch))[0], flat, allow_unused=True)
    for g, w in zip(raw, jax.tree.leaves(jgrads)):
        assert g is not None or not w.any()
    remat = dataclasses.replace(cfg, remat=True)
    loss_r, _, grads_r = steps.loss_and_grads(params, remat,
                                              port_batch(batch))
    assert torch.equal(loss_r, loss)
    for a, b in zip(leaves(grads_r), leaves(grads)):
        assert torch.equal(a, b)


def check_train_step(arch):
    cfg, params, batch, state, (_, _, _, (jp, jopt, jm)) = case(arch)
    step = steps.make_train_step(cfg, AdamWConfig(),
                                 make_schedule(ScheduleConfig(**SCHEDULE)),
                                 grad_accum=grad_accum(arch))
    opt = convert.adamw_state_from_numpy(state, params)
    new, new_opt, metrics = step(params, opt, port_batch(batch), STEP)
    moved = [np.abs(w - p.numpy()).max()
             for w, p in zip(jax.tree.leaves(jp), leaves(params))]
    leaves_close(new, jp, lambda i, w: moved[i], STEP_TOL, "params")
    assert int(new_opt["step"]) == int(jopt["step"]) == STEP + 1
    assert sorted(metrics) == sorted(jm)
    assert not any(k.startswith("expert_counts") for k in metrics)
    assert metrics["grad_step"] == STEP + 1 == int(jm["grad_step"])
    assert abs(float(metrics["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(
        float(jm["loss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_the_reference(arch):
    check_loss_and_metrics(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_the_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch):
    check_train_step(arch)


def test_router_bias_moves_by_gamma_from_a_zero_state():
    """deepseek-v3 from ``adamw_init``: the router bias has no gradient
    and starts at 0, so AdamW leaves it at 0 and the step moves each
    expert's bias by exactly +-0.001 (0 where its count is the mean),
    the sign of mean - count; the MTP term is in the metrics."""
    cfg, params, batch, _, _ = case("deepseek-v3-671b")
    step = steps.make_train_step(cfg, AdamWConfig(),
                                 make_schedule(ScheduleConfig(**SCHEDULE)))
    b = port_batch(batch)
    _, metrics, _ = steps.loss_and_grads(params, cfg, b)
    counts = metrics["expert_counts_g1"]
    new, _, m = step(params, adamw_init(params, AdamWConfig()), b, 0)
    bias = new["groups"][1]["ffn"]["router_bias"]
    want = (steps.BIAS_UPDATE_RATE * torch.sign(counts.mean() - counts))
    assert torch.equal(bias, want.expand_as(bias))
    assert bool((bias.abs() == np.float32(0.001)).any())
    assert "mtp_loss" in m and float(m["mtp_loss"]) > 0
    assert float(m["loss"]) > float(m["lm_loss"])


def test_reference_ssd_gradient_is_nan_at_chunk_256_and_the_ports_is_not():
    """mamba2's SSD layer (d_model 64, N 16, P 16) at chunk 256 over S 256:
    above the diagonal cum_i - cum_j passes 88 and the reference's
    where(mask, exp(.), 0) gives a 0 * inf gradient (NaN) in a_log,
    dt_bias and w_in. The port masks the exponent: finite everywhere,
    and equal to the reference's on every leaf the reference has
    finite. Its forward is the reference's."""
    d = 64
    jspec = JSsmSpec(d_state=16, head_dim=16, expand=2, n_groups=1,
                     conv_width=4, chunk=256)
    spec = SsmSpec(**dataclasses.asdict(jspec))
    jp, _ = JL.init_ssm(jax.random.key(0), d, jspec, jnp.float32)
    x = np.random.default_rng(5).normal(size=(1, 256, d)).astype(np.float32)
    jval, jgrads = jax.jit(jax.value_and_grad(lambda p: jnp.sum(
        JL.ssd_forward(p, jspec, d, jnp.asarray(x)) ** 2)))(jp)
    jgrads = jax.tree.map(np.asarray, jgrads)
    finite = {k for k, v in jgrads.items() if np.isfinite(v).all()}
    assert {"a_log", "dt_bias", "w_in"}.isdisjoint(finite)
    assert np.isfinite(float(jval))
    p = {k: torch.tensor(np.asarray(v)).requires_grad_()
         for k, v in jp.items()}
    val = (L.ssd_forward(p, spec, d, torch.tensor(x)) ** 2).sum()
    val.backward()
    assert abs(val.item() - float(jval)) <= LOSS_TOL * abs(float(jval))
    for k, v in p.items():
        g = v.grad.numpy()
        assert np.isfinite(g).all(), k
        if k in finite:
            assert np.abs(g - jgrads[k]).max() <= MODEL_TOL * np.abs(
                jgrads[k]).max(), k


@pytest.mark.parametrize("with_state_grad", [False, True])
def test_ssd_chunk_function_returns_the_plain_vjp(with_state_grad):
    """``SsdChunk`` on CPU tensors (its forward is then the plain version
    too): the gradient of every input, or of all but an entering state
    that needs none, equals plain autograd through ``ref.ssd_chunk``;
    an unused output (the new state) contributes a zero cotangent."""
    rng = np.random.default_rng(9)
    b, q, h, n, p = 2, 40, 3, 8, 4
    dt = np.abs(rng.normal(size=(b, q, h))).astype(np.float32) * 0.1
    raw = [rng.normal(size=(b, q, h, p)), rng.normal(size=(b, q, h, n)),
           rng.normal(size=(b, q, h, n)), dt,
           -dt * np.abs(rng.normal(size=(b, q, h))),
           rng.normal(size=(b, h, n, p))]
    need = [True] * 5 + [with_state_grad]

    def run(fn):
        ins = [torch.tensor(np.asarray(a, np.float32)).requires_grad_(r)
               for a, r in zip(raw, need)]
        y, _ = fn(*ins)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
            .backward()
        return [t.grad for t in ins]

    got, want = run(SsdChunk.apply), run(ref.ssd_chunk)
    for g, w, r in zip(got, want, need):
        assert (g is None) == (not r)
        if r:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
