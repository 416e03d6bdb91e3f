"""The port's dry-run tools against the JAX package's, on the CPU (meta
tensors: nothing is allocated or run on a device).

* ``roofline`` with a ``HwSpec`` built from the reference's TPU numbers
  gives the reference's ``to_json()`` field for field, and the ring model
  ``_wire_bytes`` is the reference's for every kind at g in {1, 2, 8,
  16};
* ``abstract_train_state`` has the reference's shapes and dtypes (params
  and AdamW state, both second-moment kinds) for every smoke
  architecture, on the meta device;
* ``cost.count`` counts a matrix product's FLOPs and bytes and the
  collectives' ring bytes;
* ``dryrun_epoch`` at the reference test's geometry (mesh (2, 4), n 512,
  D = C = 256): ``model_flops_global`` is the reference's closed form,
  ``useful_flops_ratio`` > 0.2 (the reference test's bar) and
  ``flops_per_dev`` within 25 % of the reference's (read in one
  subprocess with 8 CPU devices, ``tests/_multidev.py``);
* ``launch.specs``: the inputs of a train and a decode cell have the
  reference's shapes and dtypes, and the batch and cache specs its rank
  rules; ``launch.dryrun.run_cell`` on a decode cell writes a report with
  the reference's keys (``fits_16GB`` renamed ``fits_device``).
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.distributed import hlo as jhlo  # noqa: E402
from repro.distributed.roofline import V5E  # noqa: E402
from repro.distributed.roofline import model_flops as j_model_flops  # noqa: E402,E501
from repro.distributed.roofline import roofline as j_roofline  # noqa: E402
from repro.distributed import steps as JS  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.distributed import collectives, cost, roofline  # noqa: E402
from repro_torch.distributed import steps  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh, make_production_mesh, make_rules, mesh_name,
)
from repro_torch.optim import AdamWConfig  # noqa: E402
from tests._multidev import check_multidev  # noqa: E402

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all",
         "collective-permute")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _same_shapes(ours, theirs):
    got = dict(_leaves(ours))
    want = dict(_leaves(theirs))
    assert sorted(got) == sorted(want)
    for path, sds in want.items():
        x = got[path]
        assert x.device.type == "meta", path
        assert tuple(x.shape) == tuple(sds.shape), path
        assert str(x.dtype).removeprefix("torch.") == str(sds.dtype), path


# -- roofline and the ring model ---------------------------------------------

def test_roofline_is_the_reference_field_for_field():
    v5e = V5E
    hw = roofline.HwSpec(name=v5e.name, peak_flops=v5e.peak_flops,
                         hbm_bw=v5e.hbm_bw, link_bw=v5e.link_bw,
                         hbm_bytes=v5e.hbm_bytes)
    kw = dict(arch="a", shape="s", mesh_name="16x16", chips=256,
              flops_per_dev=3.1e13, bytes_per_dev=2.2e11,
              wire_by_kind={"all-reduce": 4e9, "total": 4e9},
              model_flops_global=5.5e15, argument_bytes=1e9,
              temp_bytes=2e9, output_bytes=3e8)
    want = j_roofline(**kw).to_json()
    got = roofline.roofline(**kw, hw=hw).to_json()
    assert got == want
    assert roofline.model_flops(7, 11, "decode") == \
        j_model_flops(7, 11, "decode")
    h100 = roofline.roofline(**kw)
    assert h100.hw is roofline.H100
    assert h100.mfu_bound == pytest.approx(
        5.5e15 / (h100.bound_seconds * 256) / 989e12)


@pytest.mark.parametrize("g", [1, 2, 8, 16])
def test_wire_bytes_are_the_reference_ring_model(g):
    for kind in KINDS:
        assert collectives._wire_bytes(kind, 4096, g) == \
            jhlo._wire_bytes(kind, 4096, g)


def test_count_sees_flops_bytes_and_collectives():
    mesh = Mesh(None, ("data",), (4,))
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")

    def fn():
        y = a @ b
        collectives.all_reduce([y] * 4, mesh, "data")
        return y

    y, totals = cost.count(fn)
    assert y.shape == (64, 16)
    assert totals.flops == 2 * 64 * 32 * 16
    # The product reads a and b and writes y; the reduce's adds read two
    # and write one each.
    assert totals.hbm_bytes >= 4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert totals.n_collectives == 1
    assert totals.wire_by_kind == {"all-reduce": 2 * 4096 * 3 / 4,
                                   "total": 2 * 4096 * 3 / 4}


# -- abstract state --------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.ARCHS)
def test_abstract_train_state_has_the_reference_shapes(arch):
    for kw in ({}, {"second_moment": "int8", "state_dtype": "bf16"}):
        jp, jo, jaxes = JS.abstract_train_state(
            jax_configs.get_smoke_config(arch), JAdamWConfig(**kw))
        p, o, axes = steps.abstract_train_state(
            configs.get_smoke_config(arch), AdamWConfig(**kw))
        _same_shapes(p, jp)
        _same_shapes(o, jo)
        assert axes == jaxes


# -- the MEMHD dry runs ------------------------------------------------------------

EPOCH = dict(n_samples=512, dim=256, columns=256)
EPOCH_CODE = """
import json, jax
from repro.core.distributed import dryrun_epoch
mesh = jax.make_mesh((2, 4), ("data", "model"))
print("REPORT" + json.dumps(dryrun_epoch(mesh, n_samples=512, dim=256,
                                         columns=256)["roofline"]))
"""


@pytest.fixture(scope="module")
def reference_epoch():
    out = check_multidev(EPOCH_CODE)
    return json.loads(out.split("REPORT", 1)[1].splitlines()[0])


def test_dryrun_epoch_matches_the_reference(reference_epoch):
    rep = distributed.dryrun_epoch(Mesh(None, ("data", "model"), (2, 4)),
                                   **EPOCH)
    r, want = rep["roofline"], reference_epoch
    assert r["model_flops_global"] == want["model_flops_global"] == \
        2.0 * 512 * (784 * 256 + 256 * 256)
    assert r["useful_flops_ratio"] > 0.2
    assert r["chips"] == want["chips"] == 8 and r["mesh"] == "2x4"
    ratio = r["flops_per_dev"] / want["flops_per_dev"]
    assert 0.75 <= ratio <= 1.25, ratio
    assert set(r) == set(want)
    # One bf16 (C, D) delta all-reduce and one of the miss count.
    assert r["wire_by_kind"]["all-reduce"] == pytest.approx(
        2 * (256 * 256 * 2 + 4) * 7 / 8)
    assert rep["memory"]["argument_bytes"] == 4 * (784 * 256 + 2 * 256 * 256
                                                   + 256 + 64 * 785)


def test_dryrun_inference_counts_one_member():
    rep = distributed.dryrun_inference(make_production_mesh(),
                                       n_queries=1 << 16)
    r = rep["roofline"]
    rows = (1 << 16) // 256
    assert r["flops_per_dev"] == 2.0 * rows * (784 * 1024 + 1024 * 1024)
    assert r["useful_flops_ratio"] == pytest.approx(1.0)
    assert r["wire_bytes_per_dev"] == 0.0 and r["mesh"] == "16x16"


# -- the LM cells -----------------------------------------------------------------

def test_cell_inputs_have_the_reference_shapes():
    for arch, shape in (("mamba2-130m", "train_4k"),
                        ("internvl2-2b", "prefill_32k"),
                        ("musicgen-medium", "train_4k"),
                        ("qwen1.5-32b", "decode_32k")):
        want = jspecs.input_specs(arch, shape)
        got = specs.input_specs(arch, shape)
        _same_shapes(got["batch"], want["batch"])
        if "caches" in want:
            # The reference stacks a group's layers (L, B, ...); the port
            # keeps a list of per-layer caches.
            for gi, layers in enumerate(got["caches"]):
                stacked = want["caches"][gi]
                for lc in layers:
                    _same_shapes(lc, jax.tree.map(
                        lambda x: jax.ShapeDtypeStruct(x.shape[1:],
                                                       x.dtype), stacked))
        assert specs.model_config_for_cell(arch, shape).shard_seq == (
            shape == "decode_32k")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_cache_specs_follow_the_reference_rules(multi_pod):
    jmesh = AbstractMesh(*(((2, 16, 16), ("pod", "data", "model"))
                           if multi_pod else ((16, 16), ("data", "model"))))
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = specs.model_config_for_cell("qwen1.5-32b", "decode_32k")
    jcfg = jspecs.model_config_for_cell("qwen1.5-32b", "decode_32k")
    for b in (128, 1):
        batch, caches = specs.decode_input_specs(cfg, 32768, b)
        jbatch, jcaches = jspecs.decode_input_specs(jcfg, 32768, b)
        got = {k: v.spec for k, v in specs.batch_shardings(
            mesh, batch).items()}
        want = {k: tuple(v.spec) for k, v in jspecs.batch_shardings(
            jmesh, jbatch).items()}
        assert got == want
        ours = specs.cache_shardings(mesh, caches, make_rules(
            mesh, shard_seq=True))
        theirs = jspecs.cache_shardings(jmesh, jcaches, JRules(
            mesh=jmesh, shard_seq=True))
        layer = ours[0][0]["attn"]
        for k in ("k", "v", "len"):
            want_spec = tuple(theirs[0]["attn"][k].spec)[1:]
            assert layer[k].spec[:len(want_spec)] == want_spec, (b, k)


def test_run_cell_writes_the_reference_report(tmp_path):
    rep = dryrun.run_cell("mamba2-130m", "decode_32k", multi_pod=False,
                          report_dir=str(tmp_path))
    assert rep["status"] == "ok", rep.get("traceback")
    assert rep["mesh"] == mesh_name(make_production_mesh()) == "16x16"
    assert rep["shard_seq"] is True and rep["chips"] == 256
    r = rep["roofline"]
    cfg = configs.get_config("mamba2-130m")
    assert r["model_flops_global"] == 2.0 * cfg.active_param_count() * 128
    assert r["flops_per_dev"] > 0 and r["dominant"] in (
        "compute", "memory", "collective")
    mem = rep["memory"]
    assert mem["fits_device"] and mem["argument_bytes"] < 1e9
    saved = json.loads((tmp_path / "mamba2-130m__decode_32k__16x16.json")
                       .read_text())
    assert saved["roofline"] == json.loads(json.dumps(r))
    want_keys = set(j_roofline(
        arch="a", shape="s", mesh_name="m", chips=1, flops_per_dev=1.0,
        bytes_per_dev=1.0, wire_by_kind={}, model_flops_global=1.0
    ).to_json())
    assert set(r) == want_keys


def test_train_cell_counts_the_gradient_all_reduce():
    cfg = configs.get_config("mamba2-130m")
    sp = configs.shape_spec("train_4k")
    assert dryrun.auto_grad_accum(sp, 256, 16) == 16
    mesh = make_production_mesh()
    rules = make_rules(mesh)
    params, opt, axes = steps.abstract_train_state(cfg, AdamWConfig())
    from repro_torch.models.sharding import param_sharding_tree, shard_shape
    p_sh = param_sharding_tree(axes, rules, params)
    small = {k: torch.empty((16, 64), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    parts = dryrun._train_parts(cfg, AdamWConfig(), rules, params, opt,
                                small, 4, p_sh)
    assert [trips for trips, _ in parts] == [4, 1]
    _, upd = cost.count(parts[1][1])
    n = sum(1 for _ in _leaves(params))
    assert upd.n_collectives == n
    shards = sum(math.prod(shard_shape(p.shape, s.spec, mesh))
                 * p.element_size()
                 for (_, p), (_, s) in zip(_leaves(params),
                                           _leaves(p_sh)))
    assert upd.wire_by_kind["all-reduce"] == pytest.approx(
        2 * shards * 15 / 16)
    assert dataclasses.is_dataclass(upd)
    assert np.isfinite(upd.hbm_bytes)


def test_a_reverse_mix_train_cell_counts_on_meta():
    """mamba2-130m at full width with bfloat16 params and float32
    activations, counted on meta tensors as a train cell's microbatch (16
    x 256 under the 16x16 mesh's rules) beside the same cell all in
    float32: the params, the gradients and the AdamW state (bf16 moments,
    as ``run_cell`` picks for bfloat16 params) take bfloat16 bytes, half
    the float32 cell's params; the residual stream and the logits are
    float32; the FLOPs are the float32 cell's and the HBM bytes at least
    its (the same float32 activations, plus each bfloat16 weight's
    widening copy and its gradient's narrowing one)."""
    from repro_torch.models.sharding import param_sharding_tree
    from repro_torch.models import transformer as T
    rules = make_rules(make_production_mesh())
    small = {k: torch.empty((16, 256), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    counts, param_bytes = {}, {}
    for pd, sd in (("bfloat16", "bf16"), ("float32", "fp32")):
        cfg = dataclasses.replace(configs.get_config("mamba2-130m"),
                                  param_dtype=pd, activation_dtype="float32")
        opt_cfg = AdamWConfig(state_dtype=sd)
        params, opt, axes = steps.abstract_train_state(cfg, opt_cfg)
        p_sh = param_sharding_tree(axes, rules, params)
        param_bytes[pd] = dryrun._sharded_bytes(params, p_sh)
        moments = [x for _, x in _leaves(opt["m"])] + [
            x for _, x in _leaves(opt["v"])]
        assert {x.dtype for x in moments} == {
            torch.bfloat16 if pd == "bfloat16" else torch.float32}
        parts = dryrun._train_parts(cfg, opt_cfg, rules, params, opt, small,
                                    1, p_sh)
        (_, _, grads), counts[pd] = cost.count(parts[0][1])
        assert {g.dtype for _, g in _leaves(grads)} == {
            torch.bfloat16 if pd == "bfloat16" else torch.float32}
        if pd == "bfloat16":
            (logits, aux), _ = cost.count(
                lambda: T.forward(params, cfg, {"tokens": small["tokens"]}))
            assert logits.device.type == "meta"
            assert logits.dtype == aux["final_hidden"].dtype == torch.float32
    assert param_bytes["bfloat16"] * 2 == param_bytes["float32"]
    assert counts["bfloat16"].flops == counts["float32"].flops > 0
    assert counts["bfloat16"].hbm_bytes >= counts["float32"].hbm_bytes
