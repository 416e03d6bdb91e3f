"""A checkpoint that the JAX package writes with bfloat16 leaves, restored
by the port's ``CheckpointManager``.

numpy has no bfloat16: the reference's ``np.save`` of a bfloat16 leaf
writes 2-byte void (``|V2``) records and names the dtype "bfloat16" in the
manifest. The port restores those bits as they are (compared as int16
views), a 0-d leaf included, and one train step of the port from the
restored tree equals, bit for bit, its step from the same tree held in
memory (``convert.lm_params_from_numpy``), at the mamba2-130m smoke
config.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import configs, convert, generator  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    AdamWConfig, ScheduleConfig, adamw_init, make_schedule,
)
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402

ARCH = "mamba2-130m"
BF16 = dict(param_dtype="bfloat16", activation_dtype="bfloat16")


def bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The reference's smoke params cast to bfloat16, with a 0-d leaf,
    saved by the reference's manager."""
    jcfg = jax_configs.get_smoke_config(ARCH)
    params, _, _ = JS.init_train_state(jax.random.key(0), jcfg,
                                       JAdamWConfig())
    params = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    tree = {"params": params, "scale": jnp.asarray(1.5, jnp.bfloat16)}
    d = str(tmp_path_factory.mktemp("ckpt"))
    jmanager.CheckpointManager(jmanager.CheckpointConfig(d)).save(3, tree)
    return d, jax.tree.map(np.asarray, tree)


def template(cfg):
    params = T.init_params(generator(1, "cpu"), cfg, device="cpu")
    return {"params": params, "scale": torch.zeros((), dtype=torch.bfloat16)}


def test_bf16_leaves_restore_bit_for_bit(saved):
    d, want = saved
    cfg = configs.get_smoke_config(ARCH, **BF16)
    step, tree, _ = manager.CheckpointManager(
        manager.CheckpointConfig(d)).restore(template(cfg))
    assert step == 3
    assert tree["scale"].shape == () and tree["scale"].dtype == torch.bfloat16
    assert float(tree["scale"]) == 1.5
    mem = convert.lm_params_from_numpy(want["params"], cfg, device="cpu")
    got, ref = tree_leaves(tree["params"]), tree_leaves(mem)
    assert len(got) == len(ref) > 10
    # Trees are compared by key: the restored dicts come back key-sorted.
    pairs = tree_map(lambda a, b: (a, b), mem, tree["params"])
    for a, b in tree_leaves_pairs(pairs):
        assert b.dtype == torch.bfloat16 and b.shape == a.shape
        np.testing.assert_array_equal(bits(b), bits(a))
    leaf = want["params"]["groups"][0]["ssm"]["w_in"]
    np.testing.assert_array_equal(
        bits(tree["params"]["groups"][0]["ssm"]["w_in"]),
        leaf.view(np.int16))


def tree_leaves_pairs(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves_pairs(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves_pairs(v)]
    return [tree]


def test_a_train_step_from_the_restored_tree_is_bit_identical(saved):
    d, want = saved
    cfg = configs.get_smoke_config(ARCH, **BF16)
    _, tree, _ = manager.CheckpointManager(
        manager.CheckpointConfig(d)).restore(template(cfg))
    mem = convert.lm_params_from_numpy(want["params"], cfg, device="cpu")
    rng = np.random.default_rng(5)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(
        2, 40)).astype(np.int32)) for k in ("tokens", "targets")}
    opt_cfg = AdamWConfig(state_dtype="bf16")
    step_fn = steps.make_train_step(cfg, opt_cfg, make_schedule(
        ScheduleConfig(warmup_steps=2, total_steps=10)))
    outs = [step_fn(p, adamw_init(p, opt_cfg), batch, 5)
            for p in (tree["params"], mem)]
    (pa, oa, ma), (pb, ob, mb) = outs
    assert torch.equal(ma["loss"], mb["loss"])
    moved = 0
    for a, b, p0 in tree_leaves_pairs(tree_map(lambda a, b, c: (a, b, c),
                                               pa, pb, mem)):
        np.testing.assert_array_equal(bits(a), bits(b))
        moved += int((bits(a) != bits(p0)).sum())
    assert moved > 0
    for a, b in tree_leaves_pairs(tree_map(lambda a, b: (a, b), oa["m"],
                                           ob["m"])):
        assert torch.equal(a, b)
