"""The port's sharded LM paths against the JAX package's, on the CPU, over
meshes whose members are all ``cpu`` (``launch.mesh.make_test_mesh``).

* ``ShardingRules.spec`` equals the reference's (as tuples) for every
  leaf of every smoke architecture's axes tree, with and without the
  leaf shapes, on a (data 2, model 4) and a (pod 2, data 2, model 2)
  mesh (the reference's rules over a ``jax.sharding.AbstractMesh``), and
  ``T.param_axes`` equals the reference's axes tree exactly.
* The sequence-parallel decode: 8 steps over a 4-member "model" axis
  equal the reference's single-device ``gqa_decode`` within 2e-4, the
  cache within 1e-5 (the reference's own contract,
  tests/test_distributed.py:272-306). At S 64 every step has shards
  wholly past the row's length (an empty shard).
* The expert-parallel MoE at the reference test's case (E 8, k 2, one
  shared expert, cf 8, mesh (2, 4)) and with DeepSeek-V3's sigmoid router
  equals the reference's ``_moe_ffn_local`` within 2e-4 with equal
  counts (the reference's own sharded MoE fails on jax 0.9 after its
  ``shard_map``, at ``layers.py:977``, so the local path is the
  reference, at a capacity where neither path drops); at cf 1.0 it drops
  exactly the slots the per-(source member, expert) capacity rule of
  ``layers.py:908-916`` and ``:926-932`` drops.
* The int8 ring reduce-scatter and all-gather over 8 members equal the
  reference's rings under ``shard_map`` (one subprocess with 8 CPU
  devices, ``tests/_multidev.py``) bit for bit on the same numpy blocks,
  as the reference's own ring test runs them (op by op). Under
  ``jax.jit`` XLA fuses the requantize and dequantize arithmetic and its
  reduce-scatter differs from the op-by-op one by up to 1.9e-6 (measured
  on these blocks, 25 % of elements); the port rounds as the op-by-op
  run does.
* The int8 error-feedback pod step at the mamba2-130m smoke config over
  2 members: its reduced gradient within 5 % of each leaf's max|exact
  float32 mean| of the whole batch's gradient, the members' reduced
  gradients (so their AdamW steps) identical, and each member's new
  residual ``ef_int8_compress``'s on that member's gradient.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import AttnSpec as JAttnSpec  # noqa: E402
from repro.models.config import FfnSpec as JFfnSpec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import collectives, steps  # noqa: E402
from repro_torch.launch.mesh import make_rules, make_test_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import AttnSpec, FfnSpec  # noqa: E402
from repro_torch.models.sharding import ShardingRules, use_rules  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, adamw_update, make_schedule,
)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from tests._multidev import check_multidev  # noqa: E402

TOL = 2e-4          # tests/test_distributed.py: decode output and MoE
CACHE_TOL = 1e-5    # tests/test_distributed.py: the decode's cache
RING_TOL = 0.05     # tests/test_distributed.py: ring vs exact sum
MESHES = {"data2_model4": ((2, 4), ("data", "model")),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model"))}


def t(a):
    return torch.as_tensor(np.array(a))


def cpu_rules(shape, axes, **kw):
    return make_rules(make_test_mesh(shape, axes, devices="cpu"), **kw)


# -- sharding rules and the axes tree ------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_axes_equal_the_reference(arch):
    with JL.abstract_init():
        jparams, jaxes = JT.init_params(jax.random.key(0),
                                        jax_configs.get_smoke_config(arch))
    cfg = configs.get_smoke_config(arch)
    assert T.param_axes(cfg) == jaxes
    with L.abstract_init():
        params = T.init_params(None, cfg)
    got = dict(_leaves(params))
    for path, sds in _leaves(jparams):
        assert tuple(got[path].shape) == tuple(sds.shape), path
        assert got[path].device.type == "meta"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp,shard_seq", [(False, False), (True, True)])
def test_sharding_specs_equal_the_reference(mesh, fsdp, shard_seq):
    shape, axes = MESHES[mesh]
    theirs = JS.ShardingRules(mesh=AbstractMesh(shape, axes), fsdp=fsdp,
                              shard_seq=shard_seq)
    ours = ShardingRules(mesh=make_test_mesh(shape, axes, devices="cpu"),
                         fsdp=fsdp, shard_seq=shard_seq)
    assert ours.table() == theirs.table()
    n = 0
    for arch in configs.ARCHS:
        cfg = configs.get_smoke_config(arch)
        with L.abstract_init():
            params = dict(_leaves(T.init_params(None, cfg)))
        for path, ax in _leaves(T.param_axes(cfg)):
            assert ours.spec(ax) == tuple(theirs.spec(ax)), (arch, path)
            shp = tuple(params[path].shape)
            assert ours.spec(ax, shp) == tuple(theirs.spec(ax, shp)), \
                (arch, path, shp)
            n += 1
    assert n > 200


# -- the sequence-parallel decode ---------------------------------------------------

@pytest.mark.parametrize("mesh_shape,softcap", [((1, 4), None),
                                                ((2, 4), None),
                                                ((1, 4), 30.0)])
def test_seq_parallel_decode_matches_the_reference(mesh_shape, softcap):
    kw = dict(kind="gqa", n_heads=8, n_kv_heads=2, head_dim=16,
              logit_softcap=softcap)
    jspec, spec = JAttnSpec(**kw), AttnSpec(**kw)
    d, b, s = 64, 4, 64
    jp, _ = JL.init_gqa(jax.random.key(0), d, jspec, jnp.float32)
    p = {k: t(v) for k, v in jp.items()}
    jcache = JL.init_gqa_cache(jspec, b, s, jnp.float32)
    xs = np.asarray(jax.random.normal(jax.random.key(1), (b, s, d)))
    rules = cpu_rules(mesh_shape, ("data", "model"), shard_seq=True)
    with use_rules(rules):
        cache = L.init_gqa_cache(spec, b, s, torch.float32, "cpu",
                                 seq_parallel=True)
    jdecode = jax.jit(lambda pp, xx, cc: JL.gqa_decode(pp, jspec, xx, cc))
    with use_rules(rules), collectives.record_collectives() as ops:
        for i in range(8):
            want, jcache = jdecode(jp, jnp.asarray(xs[:, i:i + 1]), jcache)
            got, cache = L.gqa_decode(p, spec, t(xs[:, i:i + 1]), cache,
                                      seq_parallel=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=TOL, atol=TOL)
    full = L.seq_gather_cache(cache, rules)
    for name in ("k", "v"):
        np.testing.assert_allclose(full[name].numpy(),
                                   np.asarray(jcache[name]),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
    assert cache["len"].tolist() == [8] * b
    # The reference's merge, per step: pmax, psum of l, psum of acc.
    assert [op.kind for op in ops] == ["all-reduce"] * 24
    rows = b // mesh_shape[0]
    assert [op.result_bytes for op in ops[:3]] == [
        4 * rows * 8, 4 * rows * 8, 4 * rows * 8 * 16]
    assert {op.group_size for op in ops} == {4}


def test_seq_parallel_decode_falls_back_where_the_reference_does():
    """A window, no ``shard_seq`` or a "model" size that does not divide
    S run the local decode (the cache stays whole)."""
    spec = AttnSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=8)
    p = L.init_gqa(torch.Generator().manual_seed(0), 32, spec,
                   torch.float32, "cpu")
    x = torch.ones((1, 1, 32))
    for sp, rules in ((dataclasses.replace(spec, window=8),
                       cpu_rules((1, 2), ("data", "model"), shard_seq=True)),
                      (spec, cpu_rules((1, 2), ("data", "model"))),
                      (spec, cpu_rules((1, 3), ("data", "model"),
                                       shard_seq=True))):
        cache = L.init_gqa_cache(sp, 1, 16, torch.float32, "cpu")
        with use_rules(rules):
            _, cache = L.gqa_decode(p, sp, x, cache, seq_parallel=True)
        assert isinstance(cache["k"], torch.Tensor)


def test_a_cache_built_under_the_rules_is_never_whole():
    """Under rules the sequence-parallel decode takes, ``T.init_cache``
    allocates each GQA layer's per-member blocks directly (the whole
    cache is never made); ``seq_shard_cache`` is the explicit converter
    of a whole one and ``seq_gather_cache`` its inverse; a whole cache
    handed to the sequence-parallel decode raises."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen1.5-32b"),
                              seq_parallel_decode=True)
    rules = cpu_rules((2, 2), ("data", "model"), shard_seq=True)
    spec = cfg.blocks[0].attn
    with use_rules(rules):
        caches = T.init_cache(cfg, 4, 16, device="cpu")
    n = 0
    for group in caches:
        for layer in group:
            c = layer["attn"]
            assert c["seq_shards"] == 2 and c["len"].shape == (4,)
            for name in ("k", "v"):
                assert [tuple(x.shape) for x in c[name]] == [
                    (2, 8, spec.n_kv_heads, spec.head_dim)] * 4
                assert not any(x.any() for x in c[name])
            n += 1
    assert n == cfg.n_layers
    whole = L.init_gqa_cache(spec, 4, 16, torch.float32, "cpu")
    for name in ("k", "v"):
        whole[name].copy_(torch.randn(whole[name].shape,
                                      generator=torch.Generator()
                                      .manual_seed(len(name))))
    cut = L.seq_shard_cache(whole, rules)
    back = L.seq_gather_cache(cut, rules)
    for name in ("k", "v"):
        assert torch.equal(back[name], whole[name])
        assert torch.equal(cut[name][3], whole[name][2:, 8:])
    p = L.init_gqa(torch.Generator().manual_seed(0), cfg.d_model, spec,
                   torch.float32, "cpu")
    with use_rules(rules), pytest.raises(ValueError, match="sharded"):
        L.gqa_decode(p, spec, torch.ones((4, 1, cfg.d_model)), whole,
                     seq_parallel=True)


# -- the expert-parallel MoE --------------------------------------------------------

def _moe(jspec, spec, seed=0, shape=(4, 16, 64)):
    jp, _ = JL.init_moe_ffn(jax.random.key(seed), shape[-1], jspec,
                            jnp.float32)
    x = jax.random.normal(jax.random.key(seed + 1), shape)
    return jp, {k: t(v) for k, v in jp.items()}, x


REF_MOE = dict(kind="moe", d_ff=64, n_experts=8, n_shared=1, top_k=2,
               d_ff_expert=32, router="softmax", capacity_factor=8.0)


def test_expert_parallel_moe_matches_the_reference_case():
    jspec, spec = JFfnSpec(**REF_MOE), FfnSpec(**REF_MOE)
    jp, p, x = _moe(jspec, spec)
    want, jaux = jax.jit(lambda pp, xx: JL._moe_ffn_local(pp, jspec, xx))(
        jp, x)
    rules = cpu_rules((2, 4), ("data", "model"))
    with use_rules(rules), collectives.record_collectives() as ops:
        got, aux = L.moe_ffn(p, spec, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                  rel=1e-5)
    # Two all-to-alls over "model" (4 members), counts and probs over all 8.
    assert [(op.kind, op.group_size) for op in ops] == [
        ("all-to-all", 4), ("all-to-all", 4), ("all-reduce", 8),
        ("all-reduce", 8)]
    cap = L.moe_shard_capacity(64, 8, spec)
    assert ops[0].result_bytes == 8 * cap * 64 * 4


def test_expert_parallel_moe_sigmoid_router_matches_the_reference():
    jspec = dataclasses.replace(
        jax_configs.get_smoke_config("deepseek-v3-671b").blocks[1].ffn)
    jspec = dataclasses.replace(jspec, capacity_factor=float(
        jspec.n_experts))
    spec = FfnSpec(**dataclasses.asdict(jspec))
    assert spec.router == "sigmoid"
    d = jax_configs.get_smoke_config("deepseek-v3-671b").d_model
    jp, p, x = _moe(jspec, spec, seed=4, shape=(2, 12, d))
    jp = dict(jp, router_bias=jnp.asarray(
        (np.arange(spec.n_experts) % 3 - 1) / 16, jnp.float32))
    p["router_bias"] = t(jp["router_bias"])
    want, jaux = jax.jit(lambda pp, xx: JL._moe_ffn_local(pp, jspec, xx))(
        jp, x)
    with use_rules(cpu_rules((1, 4), ("data", "model"))):
        got, aux = L.moe_ffn(p, spec, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(aux["expert_counts"].numpy(),
                                  np.asarray(jaux["expert_counts"]))
    assert "lb_loss" not in aux


def test_expert_parallel_moe_drops_by_the_capacity_rule():
    """cf 1.0: each source member keeps, per expert, its first cap =
    ceil(t_local k / E cf) slots in token order (ref layers.py:916, :932);
    every token equals the sum of its kept slots' expert outputs, and the
    drop count is the rule's."""
    spec = FfnSpec(**dict(REF_MOE, capacity_factor=1.0))
    jspec = JFfnSpec(**dict(REF_MOE, capacity_factor=1.0))
    _, p, x = _moe(jspec, spec, seed=7)
    x = t(x)
    rules = cpu_rules((2, 4), ("data", "model"))
    got, aux = L.moe_ffn(p, spec, x, rules=rules)
    xt = x.reshape(-1, 64)
    n, e, k = 8, spec.n_experts, spec.top_k
    t_local = xt.shape[0] // n
    cap = math.ceil(t_local * k / e * spec.capacity_factor)
    assert cap == L.moe_shard_capacity(xt.shape[0], n, spec)
    want = L._shared(p, xt).clone()
    dropped = 0
    for j in range(n):
        xl = xt[j * t_local:(j + 1) * t_local]
        _, top_w, top_i = L._route(xl @ p["router"], spec, None)
        seen = [0] * e
        for r in range(t_local):          # token order, then slot order
            for s in range(k):
                ex = int(top_i[r, s])
                if seen[ex] < cap:
                    h = (torch.nn.functional.silu(xl[r] @ p["w_gate"][ex])
                         * (xl[r] @ p["w_up"][ex])) @ p["w_down"][ex]
                    want[j * t_local + r] += top_w[r, s] * h
                else:
                    dropped += 1
                seen[ex] += 1
    assert dropped > 0
    np.testing.assert_allclose(got.reshape(-1, 64).numpy(), want.numpy(),
                               rtol=TOL, atol=TOL)
    assert float(aux["expert_counts"].sum()) == xt.shape[0] * k


# -- the int8 rings ----------------------------------------------------------

RING_CODE = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.optim.compression import ring_reduce_scatter_int8, ring_all_gather
g = jnp.asarray(np.load({src!r}))
mesh = jax.make_mesh((8,), ("pod",))
def f(gl):
    red = ring_reduce_scatter_int8(gl[0], "pod")
    return red[None], ring_all_gather(red, "pod")[None]
red, full = shard_map(f, mesh=mesh, in_specs=P("pod"),
                      out_specs=(P("pod"), P("pod")))(g)
np.savez({dst!r}, red=np.asarray(red), full=np.asarray(full))
print("OK")
"""


@pytest.fixture(scope="module")
def ring_blocks(tmp_path_factory):
    """8 members' (16, 1024) blocks and the reference's ring outputs."""
    d = tmp_path_factory.mktemp("rings")
    g = np.random.default_rng(0).normal(size=(8, 16, 1024)).astype(
        np.float32)
    g[3, 2] *= 1e-3       # a small block: its own scale
    g[5, 7] = 0.0         # a zero block
    np.save(d / "g.npy", g)
    check_multidev(RING_CODE.format(src=str(d / "g.npy"),
                                    dst=str(d / "out.npz")))
    out = np.load(d / "out.npz")
    return g, out["red"], out["full"]


def test_rings_equal_the_reference_bit_for_bit(ring_blocks):
    g, want_red, want_full = ring_blocks
    mesh = make_test_mesh((8,), ("pod",), devices="cpu")
    red = compression.ring_reduce_scatter_int8([t(b) for b in g], mesh,
                                               "pod")
    full = compression.ring_all_gather(red, mesh, "pod")
    for j in range(8):
        np.testing.assert_array_equal(red[j].numpy(), want_red[j])
        np.testing.assert_array_equal(full[j].numpy(), want_full[j])
    exact = g.sum(0).reshape(-1, 1024)
    assert np.abs(full[0].numpy() - exact).max() < RING_TOL * np.abs(
        exact).max()


# -- the int8 error-feedback pod step ------------------------------------------

def test_pod_step_reduces_the_gradient_and_keeps_the_residuals():
    cfg = configs.get_smoke_config("mamba2-130m")
    rules = cpu_rules((2, 1, 1), ("pod", "data", "model"))
    pod = rules.mesh.axis_mesh("pod")
    params, _ = steps.init_train_state(0, cfg, AdamWConfig(), device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: t(rng.integers(0, cfg.vocab_size, size=(4, 40)).astype(
        np.int32)) for k in ("tokens", "targets")}
    _, _, whole = steps.loss_and_grads(params, cfg, batch)
    members = [steps.loss_and_grads(params, cfg, {
        k: v[2 * j:2 * j + 2] for k, v in batch.items()})[2]
        for j in range(2)]
    ef0 = steps.init_ef_buffers(params, 2)
    reduced, _ = steps._compress_pod_grads(members, ef0, pod)
    for got, want in zip(tree_leaves(reduced[0]), tree_leaves(whole)):
        assert float((got - want).abs().max()) <= RING_TOL * float(
            want.abs().max())
    # A non-zero residual on member 1: error feedback adds it in.
    ef0[1] = {**ef0[1], "ln_f": torch.full_like(ef0[1]["ln_f"], 1e-4)}
    with collectives.record_collectives() as ops:
        reduced, ef = steps._compress_pod_grads(members, ef0, pod)
    for a, b in zip(tree_leaves(reduced[0]), tree_leaves(reduced[1])):
        assert torch.equal(a, b)
    for j in range(2):
        for g, e0, e in zip(tree_leaves(members[j]), tree_leaves(ef0[j]),
                            tree_leaves(ef[j])):
            assert torch.equal(e, compression.ef_int8_compress(g, e0)[2])
    n_leaves = len(tree_leaves(params))
    assert [op.kind for op in ops] == ["collective-permute"] * 3 * n_leaves
    # The step: AdamW once on member 0's reduced gradient, == member 1's.
    opt_cfg = AdamWConfig()
    sched = make_schedule(ScheduleConfig(warmup_steps=2, total_steps=10))
    opt = dict(adamw_init(params, opt_cfg), ef_err=ef0)
    step = steps.make_train_step(cfg, opt_cfg, sched, rules,
                                 grad_compression="int8_ef")
    new_p, new_opt, metrics = step(params, opt, batch, 5)
    assert math.isfinite(float(metrics["loss"]))
    for j in range(2):
        pj, _ = adamw_update(params, reduced[j], adamw_init(params, opt_cfg),
                             opt_cfg, sched(5))
        for a, b in zip(tree_leaves(new_p), tree_leaves(pj)):
            assert torch.equal(a, b)
    for j in range(2):
        for a, b in zip(tree_leaves(new_opt["ef_err"][j]),
                        tree_leaves(ef[j])):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="pod"):
        steps.make_train_step(cfg, opt_cfg, sched,
                              cpu_rules((1, 2), ("data", "model")),
                              grad_compression="int8_ef")


def test_rules_without_pod_change_nothing_but_the_moe_path():
    """``make_train_step(rules=)`` on a (data 1, model 2) mesh: a dense
    model's step is the plain step bit for bit."""
    cfg = configs.get_smoke_config("mamba2-130m")
    params, opt = steps.init_train_state(0, cfg, AdamWConfig(),
                                         device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: t(rng.integers(0, cfg.vocab_size, size=(2, 40)).astype(
        np.int32)) for k in ("tokens", "targets")}
    sched = make_schedule(ScheduleConfig(warmup_steps=2, total_steps=10))
    outs = [steps.make_train_step(cfg, AdamWConfig(), sched, r)(
        params, opt, batch, 5) for r in
        (None, cpu_rules((1, 2), ("data", "model")))]
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])):
        assert torch.equal(a, b)


def test_serve_step_runs_the_seq_parallel_decode_under_its_rules():
    cfg = dataclasses.replace(configs.get_smoke_config("qwen1.5-32b"),
                              seq_parallel_decode=True)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    rules = cpu_rules((1, 2), ("data", "model"), shard_seq=True)
    serve = steps.make_serve_step(cfg, rules)
    plain = steps.make_serve_step(cfg)
    with use_rules(rules):
        caches = [T.init_cache(cfg, 2, 16, device="cpu")]
    caches.append(T.init_cache(cfg, 2, 16, device="cpu"))
    toks = {"tokens": torch.tensor([[1], [2]])}
    for _ in range(3):
        got, caches[0] = serve(params, toks, caches[0])
        want, caches[1] = plain(params, toks, caches[1])
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert isinstance(caches[0][0][0]["attn"]["k"], list)
