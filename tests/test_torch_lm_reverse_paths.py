"""The reverse mix (bfloat16 params, float32 activations) on the port's
other paths, on the CPU: greedy ``generate`` against the reference's, a
reverse-mix train state that the reference checkpoints and the port
restores bit for bit, and the sharded paths, each against the port's own
unsharded reverse-mix run (the reference's sharded paths do not run on
this jax; ROADMAP): the sequence-parallel decode (``flash_decode`` with
``return_lse`` on float32 operands), the expert-parallel MoE and the int8
error-feedback pod step on bfloat16 gradients.

Tolerances: the sequence-parallel decode and the expert-parallel forward
within ``MODEL_TOL`` = 1e-4 x max|unsharded logit| (the same float32
products, merged or summed in another order; measured 5.4e-7 for the
sequence-parallel decode and 0 for the expert-parallel forward); the
expert-parallel step's bfloat16 params within one bfloat16 step of the
unsharded step's (``bf16_step``); the pod step's reduced gradient within
the int8 ring's 5 % of max|whole-batch gradient| (tests/test_distributed.py)
and its params equal to AdamW on that gradient bit for bit.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.optim import (  # noqa: E402
    AdamWConfig as JAdamWConfig, ScheduleConfig as JScheduleConfig,
    make_schedule as j_make_schedule,
)
from repro_torch import convert, generator  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.distributed import collectives, steps  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import make_rules, make_test_mesh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.sharding import use_rules  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, adamw_update, make_schedule,
)
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from test_torch_lm_mixed import pairs  # noqa: E402
from test_torch_lm_reverse import bf16_step, crossed, reverse  # noqa: E402

MODEL_TOL = 1e-4
RING_TOL = 0.05  # tests/test_distributed.py: ring vs exact sum
B, S = 2, 40
SCHEDULE = dict(warmup_steps=2, total_steps=10)
STEP = 5


def cpu_rules(shape, axes, **kw):
    return make_rules(make_test_mesh(shape, axes, devices="cpu"), **kw)


def token_batch(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    return {k: torch.tensor(rng.integers(0, cfg.vocab_size, size=(b, s))
                            .astype(np.int32)) for k in ("tokens", "targets")}


def close(got, want, tol=MODEL_TOL):
    assert got.dtype == want.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_generate_matches_the_reference(arch):
    """Greedy serving of the reverse mix: 8 prompt tokens and 8 new ones,
    token for token the reference's ``generate``."""
    cfg, params, jcfg, jparams = crossed(arch)
    prompts = token_batch(cfg, 6, s=8)["tokens"]
    want = jserve.generate(jcfg, jparams, jnp.asarray(prompts.numpy()), 8)
    got = serve.generate(cfg, params, prompts, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- a reverse-mix train state across the two packages' checkpoints ----------

ARCH = "mamba2-130m"


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A reverse-mix mamba2 train state after one reference step at lr > 0
    (bfloat16 params, fp32 moments), saved by the reference's manager."""
    jcfg = reverse(ARCH, jax_configs)
    params, opt, _ = JS.init_train_state(jax.random.key(0), jcfg,
                                         JAdamWConfig())
    jstep = JS.make_train_step(jcfg, JAdamWConfig(),
                               j_make_schedule(JScheduleConfig(**SCHEDULE)))
    batch = {k: jnp.asarray(v.numpy()) for k, v in token_batch(
        jcfg, 3).items()}
    params, opt, _ = jstep(params, opt, batch, jnp.asarray(STEP, jnp.int32))
    tree = {"params": params, "opt": opt}
    d = str(tmp_path_factory.mktemp("ckpt"))
    jmanager.CheckpointManager(jmanager.CheckpointConfig(d)).save(STEP + 1,
                                                                  tree)
    return d, jax.tree.map(np.asarray, tree)


def restored_and_in_memory(saved):
    d, want = saved
    cfg = reverse(ARCH)
    params = T.init_params(generator(1, "cpu"), cfg, device="cpu")
    template = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    step, tree, _ = manager.CheckpointManager(
        manager.CheckpointConfig(d)).restore(template)
    assert step == STEP + 1
    mem = convert.lm_params_from_numpy(want["params"], cfg, device="cpu")
    return tree, mem, convert.adamw_state_from_numpy(want["opt"], mem)


def test_reverse_train_state_restores_bit_for_bit(saved):
    """The bfloat16 params (the manifest's ``|V2`` records) and the fp32
    moments restore bit for bit, in their dtypes."""
    tree, mem, opt = restored_and_in_memory(saved)
    params = pairs(tree["params"], mem)
    moments = pairs(tree["opt"]["m"], opt["m"]) + pairs(tree["opt"]["v"],
                                                        opt["v"])
    assert len(params) > 10
    for a, b in params:
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in moments:
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)
    assert int(tree["opt"]["step"]) == int(opt["step"]) == 1
    assert bool(opt["m"]["embed"].abs().max() > 0)


def test_a_reverse_step_from_the_restored_state_is_bit_identical(saved):
    tree, mem, opt = restored_and_in_memory(saved)
    batch = token_batch(reverse(ARCH), 5)
    step_fn = steps.make_train_step(reverse(ARCH), AdamWConfig(),
                                    make_schedule(ScheduleConfig(**SCHEDULE)))
    (pa, oa, ma), (pb, ob, mb) = (step_fn(p, o, batch, STEP + 1)
                                  for p, o in ((tree["params"], tree["opt"]),
                                               (mem, opt)))
    assert torch.equal(ma["loss"], mb["loss"])
    for a, b in pairs(pa, pb) + pairs(oa["m"], ob["m"]) + pairs(oa["v"],
                                                                ob["v"]):
        assert torch.equal(a, b)
    assert {a.dtype for a, _ in pairs(pa, pb)} == {torch.bfloat16}
    assert any(not torch.equal(a, b) for a, b in pairs(pa, mem))


# -- the sharded paths against the port's unsharded run ----------------------

@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
def test_seq_parallel_decode_matches_the_unsharded_decode(mesh_shape):
    """qwen1.5-32b's smoke config, reverse mix, ``seq_parallel_decode``
    under (data, model) rules with ``shard_seq``: the caches come as
    float32 per-member blocks, every layer's attention runs one
    ``flash_decode(return_lse=True)`` per member, and 8 decode steps give
    the unsharded decode's logits."""
    cfg, params, _, _ = crossed("qwen1.5-32b")
    sp = dataclasses.replace(cfg, seq_parallel_decode=True)
    rules = cpu_rules(mesh_shape, ("data", "model"), shard_seq=True)
    serve_step = steps.make_serve_step(sp, rules)
    with use_rules(rules):
        caches = T.init_cache(sp, 4, 16, device="cpu")
    plain = T.init_cache(cfg, 4, 16, device="cpu")
    toks = token_batch(cfg, 8, b=4, s=8)["tokens"]
    ops.reset_dispatch()
    with torch.inference_mode(), collectives.record_collectives() as rec:
        for i in range(8):
            got, caches = serve_step(params, {"tokens": toks[:, i:i + 1]},
                                     caches)
            want, plain = T.decode_step(params, cfg,
                                        {"tokens": toks[:, i:i + 1]}, plain)
            close(got, want)
    layer = caches[0][0]["attn"]
    assert isinstance(layer["k"], list) and len(layer["k"]) == 4
    assert {x.dtype for x in layer["k"] + layer["v"]} == {torch.float32}
    assert ops.dispatch_breakdown()["flash_decode"]["torch-ref"] == (
        8 * cfg.n_layers * (4 + 1))
    assert {op.kind for op in rec} == {"all-reduce"}


def ep_config(cfg):
    """``cfg`` with every MoE block's capacity factor at its expert count:
    no slot drops on either path, so the two dispatches keep the same
    slots."""
    return dataclasses.replace(cfg, blocks=tuple(
        dataclasses.replace(b, ffn=dataclasses.replace(
            b.ffn, capacity_factor=float(b.ffn.n_experts)))
        if b.ffn.kind == "moe" else b for b in cfg.blocks))


def test_expert_parallel_moe_matches_the_unsharded_run():
    """deepseek-v2-lite's smoke config, reverse mix, under (data 2, model 2)
    rules: the forward (the MoE's float32 router, the bfloat16 experts
    widened to float32 on each member, two all-to-alls a layer) gives the
    unsharded forward's logits and expert counts; one train step gives the
    unsharded step's bfloat16 params within one bfloat16 step and its
    float32 routers within 1e-3 of their largest change."""
    cfg, params, _, _ = crossed("deepseek-v2-lite-16b")
    cfg = ep_config(cfg)
    rules = cpu_rules((2, 2), ("data", "model"))
    batch = token_batch(cfg, 9)
    with torch.inference_mode():
        want, waux = T.forward(params, cfg, batch)
        with use_rules(rules), collectives.record_collectives() as rec:
            got, aux = T.forward(params, cfg, batch)
    close(got, want)
    for k in waux:
        if k.startswith("expert_counts"):
            assert torch.equal(aux[k], waux[k])
    n_moe = sum(b.repeat for b in cfg.blocks if b.ffn.kind == "moe")
    assert [op.kind for op in rec].count("all-to-all") == 2 * n_moe
    sched = make_schedule(ScheduleConfig(**SCHEDULE))
    opt = adamw_init(params, AdamWConfig())
    (pa, _, ma), (pb, _, mb) = (
        steps.make_train_step(cfg, AdamWConfig(), sched, r)(
            params, opt, batch, STEP) for r in (rules, None))
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-5 * abs(
        float(mb["loss"]))
    for (a, b), (_, p) in zip(pairs(pa, pb), pairs(pb, params)):
        assert a.dtype == b.dtype == p.dtype
        err = (a.float() - b.float()).abs().max().item()
        if a.dtype == torch.bfloat16:
            assert err <= bf16_step(b.float().abs().max().item())
        else:
            assert err <= 1e-3 * (b - p).abs().max().item()


def test_pod_step_on_bfloat16_gradients():
    """mamba2's smoke config, reverse mix, on a (pod 2) mesh: each member's
    bfloat16 gradient of its half batch, int8-compressed with its float32
    residual and ring-reduced, comes back bfloat16 within the ring's
    tolerance of the whole batch's gradient and equal on both members; the
    step is AdamW on that gradient bit for bit, its params bfloat16."""
    cfg, params, _, _ = crossed("mamba2-130m")
    rules = cpu_rules((2, 1, 1), ("pod", "data", "model"))
    pod = rules.mesh.axis_mesh("pod")
    batch = token_batch(cfg, 3, b=4)
    _, _, whole = steps.loss_and_grads(params, cfg, batch)
    members = [steps.loss_and_grads(params, cfg, {
        k: v[2 * j:2 * j + 2] for k, v in batch.items()})[2]
        for j in range(2)]
    assert {g.dtype for g in tree_leaves(members[0])} == {torch.bfloat16}
    ef0 = steps.init_ef_buffers(params, 2)
    reduced, ef = steps._compress_pod_grads(members, ef0, pod)
    for got, want in zip(tree_leaves(reduced[0]), tree_leaves(whole)):
        assert got.dtype == torch.bfloat16
        assert float((got.float() - want.float()).abs().max()) <= (
            RING_TOL * float(want.float().abs().max()))
    for a, b in zip(tree_leaves(reduced[0]), tree_leaves(reduced[1])):
        assert torch.equal(a, b)
    assert {e.dtype for e in tree_leaves(ef[0])} == {torch.float32}
    opt_cfg = AdamWConfig()
    sched = make_schedule(ScheduleConfig(**SCHEDULE))
    opt = dict(adamw_init(params, opt_cfg), ef_err=ef0)
    step = steps.make_train_step(cfg, opt_cfg, sched, rules,
                                 grad_compression="int8_ef")
    new_p, new_opt, metrics = step(params, opt, batch, STEP)
    assert math.isfinite(float(metrics["loss"]))
    pj, _ = adamw_update(params, reduced[0], adamw_init(params, opt_cfg),
                         opt_cfg, sched(STEP))
    for a, b in zip(tree_leaves(new_p), tree_leaves(pj)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    for a, b in zip(tree_leaves(new_opt["ef_err"][1]), tree_leaves(ef[1])):
        assert torch.equal(a, b)
