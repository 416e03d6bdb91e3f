"""Distributed MEMHD training: data-parallel QAIL over a device list.

Port of ``repro.core.distributed``, one controller as in the reference:
the reference's mesh of local devices becomes an ordered tuple of
``torch.device``s (``deploy.sharded.serving_mesh``; a device may repeat,
so ``("cpu",) * k`` or ``(cuda:0, cuda:0)`` run k shards on one device),
not ``torch.distributed`` ranks.

  * the AM (C x D, a few MB) is replicated: it is the model, and it is
    tiny by construction (the paper's thesis); its copies on the mesh's
    other devices are refreshed whenever the binary AM changes;
  * each shard computes its Eq.-(6) delta on its own device
    (``qail.qail_batch_delta``: the ``qail_update`` kernel on a GPU), in
    the bfloat16 wire dtype;
  * the deltas and miss counts are summed on the first device in shard
    order (the reference's one bf16 ``psum``), the sum is added to the
    float AM in float32, and step 4 (normalize + re-binarize) runs there.

``make_scan_epoch_sharded`` / ``fit_sharded_epochs`` are the
data-parallel mirror of ``qail.qail_epoch_scan``; ``MemhdModel.
fit_sharded`` runs them. ``make_epoch_fn`` / ``fit_distributed`` are the
whole-epoch variant (one binary-AM snapshot per epoch, encode included);
``make_inference_fn`` the batched one-shot search. The reference's
``shardings_for`` has no counterpart beyond the split rule: every
prebatched minibatch is cut into contiguous equal row shards in mesh
order (``shard_prebatched``). ``dryrun_inference`` and ``dryrun_epoch``
count one member's run on meta tensors (``distributed.cost``) over a
``launch.mesh.Mesh`` and give the reference's roofline report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import qail
from repro_torch.core.types import EncoderConfig, MemhdConfig
from repro_torch.deploy.sharded import serving_mesh

AmState = Dict[str, torch.Tensor]
Shard = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on bfloat16 operands with float32 accumulation (the
    reference's ``preferred_element_type=f32``): the operands are rounded
    to bfloat16, their products are exact in float32."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


def _sum_on(parts: List[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The parts summed on ``device`` in list order, in their dtype."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def _replicas(mesh: tuple, state: AmState) -> Dict[torch.device, AmState]:
    """The AM on every distinct device of the mesh (its first device
    holds ``state`` itself)."""
    return {d: state if d == mesh[0] else
            {k: v.to(d) for k, v in state.items()} for d in set(mesh)}


def shard_prebatched(mesh: Sequence, hb: torch.Tensor, qb: torch.Tensor,
                     yb: torch.Tensor, mask: torch.Tensor) -> List[Shard]:
    """``qail.prebatch``'s (n_batches, batch, ...) arrays cut along the
    batch axis into one contiguous shard per mesh entry, each placed on
    its device once: [(hb, qb, yb, mask) of shard i]."""
    mesh = serving_mesh(mesh)
    bs = yb.shape[1]
    if bs % len(mesh):
        raise ValueError(f"batch {bs} does not split into {len(mesh)} "
                         "equal shards")
    rows = bs // len(mesh)
    return [tuple(t[:, i * rows:(i + 1) * rows].to(dev)
                  for t in (hb, qb, yb, mask))
            for i, dev in enumerate(mesh)]


def make_scan_epoch_sharded(cfg: MemhdConfig, mesh: Sequence,
                            refresh_every: int = 1):
    """A data-parallel scan epoch over prebatched data.

    (am_state, shards) -> (am_state, n_miss), with ``shards`` from
    ``shard_prebatched`` (the reference takes the global arrays with
    their shardings). For every batch each shard computes its
    ``qail_batch_delta`` on its device; the bfloat16 deltas and the miss
    counts are summed on the first device in shard order and the sum is
    added to ``fp`` in float32; step 4 runs every ``refresh_every``
    batches (then the replicas get the new ``fp`` / ``binary``), and the
    epoch ends with ``qail_finalize_epoch`` when the last batch did not
    refresh. The state lives on the mesh's first device; n_miss is a
    device scalar there.
    """
    mesh = serving_mesh(mesh)
    first = mesh[0]

    def epoch(am_state: AmState, shards: List[Shard]):
        nb = shards[0][0].shape[0]
        state = {k: v.to(first) for k, v in am_state.items()}
        fp, binary = state["fp"], state["binary"]
        reps = _replicas(mesh, state)
        misses = torch.zeros((), device=first)
        for b in range(nb):
            deltas, miss = [], []
            for dev, (hx, qx, yx, mx) in zip(mesh, shards):
                d, m = qail.qail_batch_delta(reps[dev], cfg, hx[b], qx[b],
                                             yx[b], mask=mx[b])
                deltas.append(d)
                miss.append(m)
            fp = fp + _sum_on(deltas, first).float()
            misses = misses + _sum_on(miss, first)
            if (b + 1) % refresh_every == 0:
                fp, binary = qail.refresh_am(fp, binary, cfg)
                reps = _replicas(mesh, dict(state, fp=fp, binary=binary))
        state = dict(state, fp=fp, binary=binary)
        if nb % refresh_every != 0:
            state = qail.qail_finalize_epoch(state, cfg)
        return state, misses

    return epoch


def fit_sharded_epochs(mesh: Sequence, am_state: AmState, cfg: MemhdConfig,
                       hb: torch.Tensor, qb: torch.Tensor, yb: torch.Tensor,
                       mask: torch.Tensor, *, epochs: int,
                       refresh_every: int = 1,
                       n_samples: Optional[int] = None,
                       ) -> Tuple[AmState, List[dict]]:
    """Run ``epochs`` data-parallel scan epochs; one host sync per epoch
    (the miss rate). Returns (am_state on the mesh's first device, curve).
    """
    mesh = serving_mesh(mesh)
    n = n_samples if n_samples is not None else int(mask.sum())
    epoch = make_scan_epoch_sharded(cfg, mesh, refresh_every)
    shards = shard_prebatched(mesh, hb, qb, yb, mask)
    state = {k: v.to(mesh[0]) for k, v in am_state.items()}
    curve = []
    for ep in range(1, epochs + 1):
        state, n_miss = epoch(state, shards)
        curve.append({"epoch": ep,
                      "train_miss": float(n_miss) / n})  # 1 sync/epoch
    return state, curve


def make_epoch_fn(enc_cfg: EncoderConfig, am_cfg: MemhdConfig, mesh=None):
    """(enc_params, am_state, feats, labels) -> (am_state, miss_rate).

    One full QAIL epoch: encode -> binary similarity -> Eq. 4/5 targets ->
    Eq. 6 delta -> normalize -> re-binarize, with one binary-AM snapshot
    per epoch (the batched semantics of the paper's §III-C). ``mesh=None``
    encodes in float32 on one device; with a mesh, each shard encodes its
    rows on bfloat16 operands with float32 accumulation (exact products:
    the projection is ±1) and the bfloat16 deltas are summed on the first
    device. Rows are zero-padded to a multiple of the shard count, the
    padding masked out.
    """
    del enc_cfg

    def single(enc_params, am_state, feats, labels):
        h = feats.float() @ enc_params["projection"].float()
        q = torch.where(h >= 0, 1.0, -1.0)
        delta, miss = qail.qail_batch_delta(am_state, am_cfg, h, q, labels)
        state = dict(am_state, fp=am_state["fp"] + delta.float())
        state = qail.qail_finalize_epoch(state, am_cfg)
        return state, miss / feats.shape[0]

    if mesh is None:
        return single
    devs = serving_mesh(mesh)
    first = devs[0]

    def epoch(enc_params, am_state, feats, labels):
        n = feats.shape[0]
        rows = -(-n // len(devs))
        pad = rows * len(devs) - n
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels.to(torch.int32), (0, pad),
                                         value=-1)
        mask = (torch.arange(rows * len(devs), device=feats.device)
                < n).float()
        state = {k: v.to(first) for k, v in am_state.items()}
        reps = _replicas(devs, state)
        proj = {d: enc_params["projection"].to(d) for d in set(devs)}
        deltas, misses = [], []
        for i, dev in enumerate(devs):
            sl = slice(i * rows, (i + 1) * rows)
            h = _bf16_matmul(feats[sl].to(dev), proj[dev])
            q = torch.where(h >= 0, 1.0, -1.0)
            d, m = qail.qail_batch_delta(reps[dev], am_cfg, h, q,
                                         labels[sl].to(dev),
                                         mask=mask[sl].to(dev))
            deltas.append(d)
            misses.append(m)
        state = dict(state, fp=state["fp"] + _sum_on(deltas, first).float())
        state = qail.qail_finalize_epoch(state, am_cfg)
        return state, _sum_on(misses, first) / n

    return epoch


def fit_distributed(mesh, model, feats: torch.Tensor, labels: torch.Tensor,
                    epochs: Optional[int] = None):
    """Run whole-epoch QAIL (``make_epoch_fn``) over ``mesh``. Returns
    the updated model, its AM on the model's device."""
    am_cfg = model.am_cfg
    epochs = am_cfg.epochs if epochs is None else epochs
    epoch = make_epoch_fn(model.enc_cfg, am_cfg, mesh)
    first = serving_mesh(mesh)[0]
    feats = torch.as_tensor(feats).to(first)
    labels = torch.as_tensor(labels).to(first)
    state = model.am_state
    for _ in range(epochs):
        state, _miss = epoch(model.enc_params, state, feats, labels)
    state = {k: v.to(model.device) for k, v in state.items()}
    return dataclasses.replace(model, am_state=state)


def make_inference_fn(enc_cfg: EncoderConfig, am_cfg: MemhdConfig):
    """Batched one-shot associative search: feats -> predicted classes.

    The paper's deployment workload (§III-D): projection-encode on
    bfloat16 operands (float32 accumulation), binarize, the similarity
    product against the binary AM (exact: ±1 operands), first-wins
    argmax, ownership lookup.
    """
    del enc_cfg, am_cfg

    def infer(enc_params, binary_am, centroid_class, feats):
        h = _bf16_matmul(feats, enc_params["projection"])
        q = torch.where(h >= 0, 1.0, -1.0)
        sims = _bf16_matmul(q, binary_am.T)
        return centroid_class[torch.argmax(sims, dim=-1)]

    return infer


def _meta(*shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dryrun(arch: str, mesh, run, inputs, model_flops: float, dim: int,
            columns: int) -> Dict:
    """Count one member's ``run()`` on meta tensors and report it as the
    reference does: {"roofline", "memory"}, the argument bytes those of
    ``inputs`` (the member's, the AM replicated)."""
    from repro_torch.distributed import cost
    from repro_torch.distributed.roofline import roofline
    from repro_torch.launch.mesh import mesh_name
    _, totals = cost.count(run)
    arg_bytes = sum(x.numel() * x.element_size() for x in inputs)
    rep = roofline(
        arch=arch, shape=f"{dim}x{columns}", mesh_name=mesh_name(mesh),
        chips=mesh.size, flops_per_dev=totals.flops,
        bytes_per_dev=totals.hbm_bytes, wire_by_kind=totals.wire_by_kind,
        model_flops_global=model_flops, argument_bytes=float(arg_bytes),
        temp_bytes=totals.peak_bytes)
    return {"roofline": rep.to_json(),
            "memory": {"argument_bytes": int(arg_bytes),
                       "temp_bytes": int(totals.peak_bytes)}}


def dryrun_inference(mesh, *, features: int = 784, dim: int = 1024,
                     columns: int = 1024, n_queries: int = 1_048_576
                     ) -> Dict:
    """Roofline of the batched one-shot search (``make_inference_fn``) on
    ``mesh`` (a ``launch.mesh.Mesh``, abstract allowed): one member's run
    counted on meta tensors (``distributed.cost``) at n_queries / chips
    rows (the batch over every mesh axis, the model replicated: the
    reference's ``_batch_axes``); it issues no collective. ``temp_bytes``
    is the peak of the run's live op outputs."""
    proj = _meta(features, dim, dtype=torch.bfloat16)
    am = _meta(columns, dim, dtype=torch.bfloat16)
    owners = _meta(columns, dtype=torch.int32)
    feats = _meta(-(-n_queries // mesh.size), features, dtype=torch.bfloat16)
    infer = make_inference_fn(None, None)
    return _dryrun("memhd-search", mesh,
                   lambda: infer({"projection": proj}, am, owners, feats),
                   (proj, am, owners, feats),
                   2.0 * n_queries * (features * dim + dim * columns),
                   dim, columns)


def dryrun_epoch(mesh, *, features: int = 784, dim: int = 1024,
                 columns: int = 1024, classes: int = 10,
                 n_samples: int = 61_440) -> Dict:
    """Roofline of one distributed QAIL epoch (``make_epoch_fn``) on
    ``mesh``: one member's epoch counted on meta tensors at n_samples /
    chips rows (encode, similarity, the ``qail_update`` delta, normalize
    and re-binarize; the AM replicated), plus the epoch's collectives as
    ``make_epoch_fn`` issues them: one all-reduce of the bfloat16 (C, D)
    delta and one of the miss count over every member. Useful FLOPs are
    the reference's closed form (encode + similarity MVMs, no backprop)."""
    from repro_torch.distributed import collectives
    am_cfg = MemhdConfig(dim=dim, columns=columns, classes=classes)
    enc = {"projection": _meta(features, dim)}
    am = {"fp": _meta(columns, dim), "binary": _meta(columns, dim),
          "centroid_class": _meta(columns, dtype=torch.int32)}
    rows = -(-n_samples // mesh.size)
    feats, labels = _meta(rows, features), _meta(rows, dtype=torch.int32)
    epoch = make_epoch_fn(None, am_cfg, ("meta",))

    def run():
        out = epoch(enc, am, feats, labels)
        collectives.account("all-reduce", columns * dim * 2, mesh.size)
        collectives.account("all-reduce", 4, mesh.size)
        return out

    return _dryrun("memhd-qail", mesh, run,
                   (enc["projection"], *am.values(), feats, labels),
                   2.0 * n_samples * (features * dim + dim * columns),
                   dim, columns)
