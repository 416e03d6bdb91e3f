"""The port's optimizer substrate and LM data pipeline against the JAX
package's, on the CPU: the schedules, AdamW (one and two steps from a
non-zero state crossed with ``convert.adamw_state_from_numpy``, fp32 and
bf16 states, dense and int8 second moments), the int8 blockings of ``v``
and of the compressed gradient, ``next_batch`` and the checkpoint of an
optimizer state.

Operands are drawn with numpy. Tolerances: the schedule within 1 float32
ulp of 1 (1.2e-7); float32 leaves within 2e-6 x max|leaf| (the same
elementwise float32 arithmetic; the global norm's sum runs in another
order, which moves the clip factor by an ulp); bfloat16 leaves within
one bfloat16 ulp of the reference; int8 codes of v within 1 (a float32
ulp of v can cross a rounding boundary), float32 scales within 2e-6
relative.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointConfig, CheckpointManager,
)
from repro_torch.data import lm  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, adamw_update, ef_int8_compress,
    ef_int8_decompress, make_schedule,
)
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import _dq_v, _q_v, tree_leaves  # noqa: E402

F32_TOL = 2e-6


# -- schedule -------------------------------------------------------------------

@pytest.mark.parametrize("kind,warmup,min_ratio", [
    ("cosine", 10, 0.1), ("linear", 0, 0.0), ("linear", 7, 0.2),
    ("constant", 5, 0.1)])
def test_schedule_matches_the_reference(kind, warmup, min_ratio):
    kw = dict(kind=kind, warmup_steps=warmup, total_steps=100,
              min_ratio=min_ratio)
    want = jsched.make_schedule(jsched.ScheduleConfig(**kw))
    got = make_schedule(ScheduleConfig(**kw))
    for step in (0, 1, 3, warmup, 20, 55, 99, 100, 150):
        g = got(step)
        assert g.dtype == torch.float32 and g.dim() == 0
        assert abs(float(g) - float(want(step))) <= 1.2e-7, (step, g)
    assert float(got(torch.tensor(20, dtype=torch.int32))) == float(got(20))
    with pytest.raises(ValueError, match="kind"):
        ScheduleConfig(kind="step")


# -- AdamW --------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    """A param-shaped tree: dicts, a list of stacked groups, a bf16 leaf,
    a ragged leaf (not a multiple of the 128-block) and a float32 bias."""
    def a(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"embed": a(40, 8),
            "groups": [{"w": a(2, 8, 24), "ln": a(2, 8)},
                       {"router_bias": a(1, 5)}],
            "ln_f": a(8)}


def _bf16_leaf(tree):
    return dict(tree, embed=tree["embed"].astype(jnp.bfloat16))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def leaf_close(got, want):
    """``got`` (a port leaf) against ``want`` (a reference leaf)."""
    if isinstance(want, tuple):  # int8 v: (q, scale)
        q, s = (np.asarray(x) for x in want)
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
        dq = np.abs(got[0].numpy().astype(np.int32) - q.astype(np.int32))
        assert dq.max() <= 1, dq.max()
        np.testing.assert_allclose(got[1].numpy(), s, rtol=F32_TOL)
        return
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    if got.dtype == torch.bfloat16:
        assert want.dtype == jnp.bfloat16
        _, e = np.frexp(np.abs(w))
        assert (np.abs(g - w) <= np.ldexp(1.0, e - 8)).all()
    else:
        assert got.dtype == torch.float32
        assert np.abs(g - w).max() <= F32_TOL * max(np.abs(w).max(), 1e-30)


def trees_close(got, want):
    """Leaf by leaf, walking both trees by key and index."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            trees_close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            trees_close(g, w)
    else:
        leaf_close(got, want)


@pytest.mark.parametrize("steps", [1, 2])
@pytest.mark.parametrize("state_dtype,second", [
    ("fp32", "dense"), ("bf16", "dense"), ("fp32", "int8"),
    ("bf16", "int8")])
def test_adamw_matches_the_reference(state_dtype, second, steps):
    """From a non-zero state (three reference steps in), ``steps`` more
    updates on both sides: params, m, v and step. The grads of the
    second step are large enough that the global-norm clip acts."""
    rng = np.random.default_rng([7, steps, len(state_dtype + second)])
    kw = dict(lr=0.01, state_dtype=state_dtype, second_moment=second)
    jcfg, cfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    params = _bf16_leaf(_jax(_tree(rng)))
    state = jadamw.adamw_init(params, jcfg)
    for i in range(3):
        params, state = jadamw.adamw_update(
            params, _jax(_tree(rng, 0.05)), state, jcfg, 0.5)
    p = convert._lm_tree(jax.tree.map(np.asarray, params), "cpu")
    s = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, state), p)
    assert int(s["step"]) == 3 and s["step"].dtype == torch.int32
    trees_close(s["m"], state["m"])
    for i in range(steps):
        grads = _tree(rng, 0.05 if i == 0 else 3.0)
        params, state = jadamw.adamw_update(params, _jax(grads), state,
                                            jcfg, 0.7)
        before = [t.clone() for t in tree_leaves(p)]
        p, s = adamw_update(p, convert._lm_tree(grads, "cpu"), s, cfg,
                            torch.tensor(0.7))
        # A new tree: the inputs are not written.
        assert all(t is not u for t, u in zip(tree_leaves(p), before))
    trees_close(p, params)
    trees_close(s["m"], state["m"])
    trees_close(s["v"], state["v"])
    assert int(s["step"]) == int(state["step"]) == 3 + steps


def test_adamw_init_and_state_bytes():
    p = convert._lm_tree(_tree(np.random.default_rng(0)), "cpu")
    s = adamw_init(p, AdamWConfig(state_dtype="bf16", second_moment="int8"))
    assert s["m"]["embed"].dtype == torch.bfloat16
    q, scale = s["v"]["groups"][0]["w"]
    assert q.shape == (3, 128) and q.dtype == torch.int8  # 384 / 128
    assert scale.shape == (3, 1) and not q.any()
    assert int(s["step"]) == 0
    for kw, want in ((dict(state_dtype="fp32"), 8),
                     (dict(state_dtype="bf16"), 4),
                     (dict(state_dtype="bf16", second_moment="int8"), 3.04)):
        assert AdamWConfig(**kw).state_bytes_per_param() == pytest.approx(
            want) == jadamw.AdamWConfig(**kw).state_bytes_per_param()
    with pytest.raises(ValueError):
        AdamWConfig(second_moment="int4")


def test_adamw_clip_keeps_a_huge_gradient_finite():
    cfg = AdamWConfig(lr=1.0, grad_clip_norm=1e-3, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    new, _ = adamw_update(p, {"w": torch.full((4,), 1e9)},
                          adamw_init(p, cfg), cfg)
    assert torch.isfinite(new["w"]).all()


# -- int8 blockings -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 128, 1000, 2048 + 5])
def test_int8_blockings_match_the_reference_codes(n):
    """``_q_v`` (positive v, 128-blocks) and ``ef_int8_compress`` (signed,
    1024-blocks) give the reference's int8 codes exactly, with operands
    that include exact half steps (round half to even on both sides)."""
    rng = np.random.default_rng(n)
    v = np.abs(rng.normal(size=(n,))).astype(np.float32) * 1e-4
    v[::7] = 0.0
    q, s = _q_v(torch.tensor(v))
    jq, js = jadamw._q_v(jnp.asarray(v))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(_dq_v(q, s, v.shape, n).numpy(),
                               np.asarray(jadamw._dq_v(jq, js, v.shape, n)),
                               rtol=1e-7)
    g = rng.normal(size=(n,)).astype(np.float32)
    g[: min(n, 4)] = [127.0, 0.5, -0.5, 1.5][: min(n, 4)]  # half steps
    err = (rng.normal(size=(n,)) * 1e-3).astype(np.float32)
    q, s, e = ef_int8_compress(torch.tensor(g), torch.tensor(err))
    jq, js, je = jcomp.ef_int8_compress(jnp.asarray(g), jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-7)
    np.testing.assert_allclose(
        ef_int8_decompress(q, s, g.shape, n).numpy(),
        np.asarray(jcomp.ef_int8_decompress(jq, js, g.shape, n)), rtol=1e-7)


def test_ring_collectives_sum_over_four_members():
    """Over a 4-member "pod" mesh of CPU members the int8 reduce-scatter
    and the all-gather give every member the same sum, within 5 % of
    max|sum| (the reference's ring contract; bit parity with the
    reference's rings is in tests/test_torch_lm_sharded.py), in 2 x 3 + 3
    permutes."""
    from repro_torch.distributed.collectives import record_collectives
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((4,), ("pod",), devices="cpu")
    g = np.random.default_rng(1).normal(size=(4, 8, 1024)).astype(np.float32)
    with record_collectives() as ops:
        red = compression.ring_reduce_scatter_int8(
            [torch.tensor(b) for b in g], mesh, "pod")
        out = compression.ring_all_gather(red, mesh, "pod")
    assert [r.shape for r in red] == [(2, 1024)] * 4
    want = g.sum(0)
    assert np.abs(out[0].numpy() - want).max() < 0.05 * np.abs(want).max()
    assert all(torch.equal(o, out[0]) for o in out)
    assert [op.kind for op in ops] == ["collective-permute"] * 9


# -- LM data ------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_next_batch_is_the_reference_bit_for_bit(seed):
    kw = dict(vocab_size=512, seq_len=64, global_batch=3)
    cfg, jcfg = lm.LmDataConfig(**kw), jlm.LmDataConfig(**kw)
    st, jst = lm.PipelineState(seed), jlm.PipelineState(seed)
    for _ in range(3):
        (b, st), (jb, jst) = lm.next_batch(cfg, st), jlm.next_batch(jcfg,
                                                                     jst)
        assert sorted(b) == sorted(jb) == ["targets", "tokens"]
        for k in b:
            assert b[k].dtype == np.int32 and b[k].shape == (3, 64)
            np.testing.assert_array_equal(b[k], jb[k])
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["targets"][:, :-1])
    assert st.to_json() == jst.to_json() == {"seed": seed, "position": 3}
    # A JSON round trip resumes the same stream.
    back = lm.PipelineState.from_json(json.loads(json.dumps(st.to_json())))
    assert back == st
    np.testing.assert_array_equal(lm.next_batch(cfg, back)[0]["tokens"],
                                  jlm.next_batch(jcfg, jst)[0]["tokens"])


# -- checkpoints of the optimizer state ---------------------------------------------

@pytest.mark.parametrize("state_dtype,second", [("bf16", "int8"),
                                                ("fp32", "dense")])
def test_checkpoint_round_trips_the_train_state(tmp_path, state_dtype,
                                                second):
    """bf16 leaves (params and moments) and int8 ``v`` tuples come back bit
    for bit, with their dtypes and tuple structure."""
    rng = np.random.default_rng(11)
    cfg = AdamWConfig(state_dtype=state_dtype, second_moment=second)
    p = convert._lm_tree(_bf16_leaf(_jax(_tree(rng))), "cpu")
    s = adamw_init(p, cfg)
    for _ in range(2):
        p, s = adamw_update(p, convert._lm_tree(_tree(rng), "cpu"), s, cfg)
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), keep=2))
    mgr.save(2, {"params": p, "opt": s}, extra={"pipeline": {"seed": 0}})
    template = {"params": jax.tree.map(torch.zeros_like, p),
                "opt": adamw_init(p, cfg)}
    step, tree, extra = mgr.restore(template)
    assert step == 2 and extra == {"pipeline": {"seed": 0}}
    def same(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert type(g) is type(w) and len(g) == len(w)
            for a, b in zip(g, w):
                same(a, b)
        else:
            assert g.dtype == w.dtype and torch.equal(g, w)

    same(tree, {"params": p, "opt": s})
    assert tree["params"]["embed"].dtype == torch.bfloat16
    manifest = json.load(open(tmp_path / "step_0000000002" /
                              "manifest.json"))
    assert manifest["files"]["params/embed"]["dtype"] == "bfloat16"
