"""Dry run of the LM cells on the reference's production meshes, on the
CPU and with no card: per-device memory and roofline terms.

Port of ``repro.launch.dryrun``. For each (arch x shape x mesh) cell the
step's state and inputs are built abstract (empty meta tensors:
``abstract_train_state``, ``launch.specs``), their shardings from the
rules (``param_sharding_tree``, ``specs.batch_shardings`` /
``cache_shardings``), and one step is counted on meta
(``distributed.cost.count``) at the global shape, under the rules: the
expert-parallel MoE runs over the abstract mesh's members and records
its all-to-alls. The report has

  * ``memory``: per-device argument bytes, the sum of the shard bytes of
    params, optimizer state, batch and caches; ``fits_device`` compares
    them with the ``HwSpec``'s HBM;
  * ``roofline``: FLOPs and bytes of the step / chips (an ideal
    partition of the counted work), and wire bytes: the recorded
    collectives plus one ring all-reduce of each gradient leaf's shard
    over the batch axes (train cells).

What it leaves out: the FSDP and tensor-parallel all-gathers and
reduce-scatters that GSPMD inserts into the reference's partitioned
step (the port has no compiler placing params and activations, so
nothing issues them), and buffer reuse (``temp_bytes`` is the peak of
the run's live op outputs / chips). Reports go to
``reports/dryrun_torch/<arch>__<shape>__<mesh>.json`` with the
reference's keys, ``fits_16GB`` renamed ``fits_device``.

Usage (CPU):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
      --shape train_4k --mesh single            # one cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import time
import traceback

log = logging.getLogger("dryrun")

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


def _sharded_bytes(tree, shardings) -> int:
    """Σ one member's block bytes of ``tree``'s tensors under the matching
    ``NamedSharding``s (None: replicated)."""
    from repro_torch.models.sharding import shard_bytes
    if isinstance(tree, dict):
        return sum(_sharded_bytes(v, shardings[k] if shardings is not None
                                  else None) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_sharded_bytes(v, shardings[i] if isinstance(
            shardings, (list, tuple)) else shardings)
            for i, v in enumerate(tree))
    if shardings is None:
        return tree.numel() * tree.element_size()
    return shard_bytes(tree, shardings.spec, shardings.mesh)


def auto_grad_accum(sp, chips: int, model: int) -> int:
    """The reference's microbatching rule: keep ~4k tokens a chip a
    microbatch, and microbatches shardable over the data axes."""
    data_shards = chips // model
    tokens_local = sp.seq_len * sp.global_batch // data_shards
    max_accum = max(1, sp.global_batch // data_shards)
    accum = 1
    while tokens_local // accum > 4096 and accum * 2 <= max_accum:
        accum *= 2
    return accum


def _train_parts(cfg, opt_cfg, rules, params, opt, batch, grad_accum,
                 p_sh) -> list:
    """A train step as (trip count, function) parts to count: one
    microbatch's forward and backward under the rules, run ``grad_accum``
    times (counted once and scaled, as ``hlo_cost`` scales a loop body by
    its trip count), then the AdamW update and the data-parallel gradient
    all-reduce (one ring all-reduce of each leaf's shard over the batch
    axes) once."""
    import torch

    from repro_torch.distributed import collectives
    from repro_torch.distributed.steps import loss_and_grads
    from repro_torch.models.sharding import shard_bytes, use_rules
    from repro_torch.optim import ScheduleConfig, adamw_update, make_schedule
    from repro_torch.optim.adamw import tree_leaves, tree_map

    mesh = rules.mesh
    micro = {k: v[:v.shape[0] // grad_accum] for k, v in batch.items()}
    g = mesh.axis_size(tuple(a for a in ("pod", "data")
                             if a in mesh.axis_names))
    shards = [shard_bytes(p, s.spec, mesh) for p, s in
              zip(tree_leaves(params), tree_leaves(p_sh))]
    grad_dtype = torch.float32 if grad_accum > 1 else None
    sched = make_schedule(ScheduleConfig())

    def backward():
        with use_rules(rules):
            return loss_and_grads(params, cfg, micro)

    def update():
        grads = tree_map(lambda p: torch.empty(
            p.shape, dtype=grad_dtype or p.dtype, device=p.device), params)
        for nbytes in shards:
            collectives.account("all-reduce", nbytes, g)
        return adamw_update(params, grads, opt, opt_cfg, sched(0))

    return [(grad_accum, backward), (1, update)]


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             overrides: dict | None = None,
             report_dir: str = REPORT_DIR) -> dict:
    """Count one cell; returns (and writes) the report dict."""
    from repro_torch.configs import shape_spec
    from repro_torch.distributed import cost
    from repro_torch.distributed.roofline import H100, roofline
    from repro_torch.distributed.steps import (
        abstract_train_state, make_serve_step,
    )
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import (
        make_production_mesh, make_rules, mesh_name,
    )
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import param_sharding_tree
    from repro_torch.optim import AdamWConfig

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    sp = shape_spec(shape)
    cfg = S.model_config_for_cell(arch, shape)
    overrides = dict(overrides or {})
    forced_accum = overrides.pop("grad_accum", None)
    rule_overrides = overrides.pop("rule_overrides", None)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    rules = make_rules(mesh, fsdp=cfg.fsdp, shard_seq=cfg.shard_seq,
                       overrides=rule_overrides)
    opt_cfg = AdamWConfig(state_dtype="bf16" if cfg.param_dtype ==
                          "bfloat16" else "fp32")
    chips = mesh.size
    report = {
        "arch": arch, "shape": shape, "mesh": mesh_name(mesh),
        "chips": chips, "step": sp.step, "status": "error",
        "fsdp": cfg.fsdp, "shard_seq": cfg.shard_seq,
        "overrides": {k: str(v) for k, v in overrides.items()},
    }
    try:
        if sp.step == "train":
            params, opt, axes = abstract_train_state(cfg, opt_cfg)
            p_sh = param_sharding_tree(axes, rules, params)
            batch = S.train_input_specs(cfg, sp.seq_len, sp.global_batch)
            if forced_accum is not None:
                grad_accum = int(forced_accum)
                report["overrides"]["grad_accum"] = grad_accum
            else:
                grad_accum = auto_grad_accum(sp, chips, mesh.shape["model"])
            report["grad_accum"] = grad_accum
            arg_bytes = (_sharded_bytes(params, p_sh)
                         + _sharded_bytes(opt["m"], p_sh)
                         + _sharded_bytes(opt["v"], p_sh)
                         + opt["step"].element_size())
            steps = _train_parts(cfg, opt_cfg, rules, params, opt, batch,
                                 grad_accum, p_sh)
            model_flops = 6.0 * cfg.active_param_count() * (
                sp.seq_len * sp.global_batch)
        else:
            with L.abstract_init():
                params = T.init_params(None, cfg)
            p_sh = param_sharding_tree(T.param_axes(cfg), rules, params)
            batch, caches = S.decode_input_specs(cfg, sp.seq_len,
                                                 sp.global_batch)
            c_sh = S.cache_shardings(mesh, caches, rules)
            serve = make_serve_step(cfg, rules)
            arg_bytes = (_sharded_bytes(params, p_sh)
                         + _sharded_bytes(caches, c_sh))

            steps = [(1, lambda: serve(params, batch, caches))]
            model_flops = 2.0 * cfg.active_param_count() * sp.global_batch
        arg_bytes += _sharded_bytes(batch, S.batch_shardings(mesh, batch))
        t_count = time.time()
        totals = cost.CostTotals()
        for trips, fn in steps:
            totals = totals.add(cost.count(fn)[1].scaled(trips))
        rep = roofline(
            arch=arch, shape=shape, mesh_name=mesh_name(mesh), chips=chips,
            flops_per_dev=totals.flops / chips,
            bytes_per_dev=totals.hbm_bytes / chips,
            wire_by_kind=totals.wire_by_kind,
            model_flops_global=model_flops, argument_bytes=arg_bytes,
            temp_bytes=totals.peak_bytes / chips)
        report.update(
            status="ok", count_s=round(time.time() - t_count, 2),
            roofline=rep.to_json(),
            memory={"argument_bytes": int(arg_bytes),
                    "temp_bytes": int(totals.peak_bytes / chips),
                    "hbm_bytes": H100.hbm_bytes,
                    "fits_device": bool(arg_bytes < H100.hbm_bytes)},
            n_collectives=totals.n_collectives)
    except Exception as e:  # noqa: BLE001 -- report and continue
        report.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    report["total_s"] = round(time.time() - t0, 2)
    os.makedirs(report_dir, exist_ok=True)
    tag = "_".join(f"{k}-{v}" for k, v in report["overrides"].items())
    if len(tag) > 48:  # long structured overrides: a stable short hash
        tag = hashlib.md5(tag.encode()).hexdigest()[:10]
    fn = os.path.join(report_dir, f"{arch}__{shape}__{report['mesh']}"
                      + (f"__{tag}" if tag else "") + ".json")
    with open(fn, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-skipped", action="store_true",
                    help="also attempt cells marked SKIP (full-attn 500k)")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    args = ap.parse_args(argv)

    from repro_torch.configs import cell_applicable, cells
    from repro_torch.obs import setup_logging
    setup_logging()

    if args.all:
        todo = list(cells(include_skipped=args.include_skipped))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    for arch, shape in todo:
        if not cell_applicable(arch, shape) and not args.include_skipped:
            log.info("SKIP %s x %s (inapplicable)", arch, shape)
            continue
        for mp in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            log.info("dry-run %s ...", tag)
            rep = run_cell(arch, shape, multi_pod=mp,
                           report_dir=args.report_dir)
            extra = ""
            if rep["status"] == "ok":
                r = rep["roofline"]
                extra = (f" dominant={r['dominant']}"
                         f" bound={r['bound_seconds']:.4f}s"
                         f" fits={rep['memory']['fits_device']}")
            else:
                log.error("  error: %s", rep.get("error"))
            log.info("%s -> %s (%.1fs)%s", tag, rep["status"],
                     rep["total_s"], extra)
            results.append(rep)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n=== dry-run: {n_ok}/{len(results)} cells OK ===")
    for r in results:
        if r["status"] != "ok":
            print(f"FAILED {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"{r.get('error')}")
    return results


if __name__ == "__main__":
    main()
