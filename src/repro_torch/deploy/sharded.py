"""Multi-device sharded serving on top of any deployment backend.

Port of ``repro.deploy.sharded``. ``ShardedArtifact`` wraps a
``DeployedArtifact`` (any registry backend: the wrapper only uses the
protocol surface) and serves its query path data-parallel: the artifact
is replicated (the AM is the model, and it is tiny by construction), the
batch axis is cut into one contiguous shard per mesh entry, and each
shard runs the backend's own kernels on its rows. Predictions are
row-local, so sharded serving equals the single-device path bit for bit.

The reference is one controller driving a ``jax`` mesh of local
devices; so is the port, over an ordered tuple of ``torch.device``s
(``serving_mesh``) instead of ``torch.distributed`` ranks. An entry is a
shard, and a device may repeat: ``("cpu",) * k`` is the counterpart of
the reference's ``--xla_force_host_platform_device_count``, and
``(cuda:0, cuda:0)`` puts two shards on one card. The artifact's tensors
are copied once to each distinct device (at wrap and at swap); repeated
entries share that replica.

Ragged batches follow the padded-evaluator contract: rows are
zero-padded up to a multiple of the shard count (zero feature rows
encode to a valid query) and the padded tail is dropped.

    dep = model.deploy(target="packed")
    sharded = ShardedArtifact(dep, devices=8)   # or mesh=(...)
    preds = sharded.predict(feats)              # == dep.predict(feats)

``launch/serve_memhd.py --devices N`` and ``launch/serve_online.py
--devices N`` build on this wrapper.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import on_device
from repro_torch.deploy.padding import pad_rows, round_up

Mesh = Tuple[torch.device, ...]


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def serving_mesh(devices: Optional[Sequence] = None,
                 n: Optional[int] = None) -> Mesh:
    """An ordered tuple of devices, one shard each: ``devices`` (any
    torch devices, repeats allowed) or, by default, every visible CUDA
    device; the first ``n`` of them when ``n`` is given."""
    if devices is None:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [_normalize(d) for d in devices]
    if n is not None:
        if n < 1 or n > len(devs):
            raise ValueError(f"requested {n} devices, have {len(devs)} "
                             f"({[str(d) for d in devs[:4]]}...)")
        devs = devs[:n]
    if not devs:
        raise ValueError("no devices to shard over (no CUDA device is "
                         "visible; pass devices=['cpu'] * k)")
    return tuple(devs)


def _replica(artifact, device: torch.device):
    """``artifact`` with every tensor field (and every tensor of a dict
    field) copied to ``device``."""
    changes = {}
    for f in dataclasses.fields(artifact):
        v = getattr(artifact, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = v.to(device)
        elif isinstance(v, dict):
            changes[f.name] = {k: t.to(device) if isinstance(t, torch.Tensor)
                               else t for k, t in v.items()}
    return dataclasses.replace(artifact, **changes)


class _Replicas:
    """Replicas of served artifacts by device, shared by a wrapper and
    every wrapper ``with_artifact`` derives from it: an artifact is copied
    to each distinct device once, its own device serves it as it is, and
    its copies go when it does."""

    def __init__(self):
        self._by_artifact: Dict[int, Dict[torch.device, object]] = {}

    def of(self, artifact, devices) -> Dict[torch.device, object]:
        key = id(artifact)
        reps = self._by_artifact.get(key)
        if reps is None:
            reps = {d: _replica(artifact, d) for d in devices
                    if d != artifact.device}
            self._by_artifact[key] = reps
            weakref.finalize(artifact, self._by_artifact.pop, key, None)
        return reps

    def __len__(self) -> int:
        return len(self._by_artifact)


def _cat(outs: list, device: torch.device):
    """The shards' outputs, in shard order, on ``device`` (a tuple of
    outputs element by element)."""
    if isinstance(outs[0], tuple):
        return tuple(_cat(list(parts), device) for parts in zip(*outs))
    return torch.cat([o.to(device) for o in outs])


def _trim(out, n: int):
    if isinstance(out, tuple):
        return tuple(o[:n] for o in out)
    return out[:n]


class ShardedArtifact:
    """Data-parallel serving wrapper around any deployment artifact.

    Query methods (``predict`` / ``predict_features`` / ``predict_query``
    / ``predict_topk``) cut the batch over the mesh; everything else
    (``backend``, ``serving_mode``, residence accounting, configs)
    delegates to the wrapped artifact, so the wrapper drops into any code
    programmed against the ``DeployedArtifact`` protocol. Outputs land on
    the mesh's first device, which is also the wrapper's ``device``.
    """

    def __init__(self, artifact, mesh: Optional[Sequence] = None,
                 devices: Optional[int] = None):
        if isinstance(artifact, ShardedArtifact):
            raise TypeError("artifact is already sharded")
        self.artifact = artifact
        self.mesh = (serving_mesh(mesh) if mesh is not None
                     else serving_mesh(n=devices))
        self.n_devices = len(self.mesh)
        self._replicas = _Replicas()
        self._replicas.of(artifact, set(self.mesh))

    def __getattr__(self, name):
        # Only reached for names not set on the wrapper itself.
        if name in ("artifact", "mesh", "n_devices", "_replicas"):
            raise AttributeError(name)
        return getattr(self.artifact, name)

    @property
    def device(self) -> torch.device:
        """Where batches are handed in and results land: the first shard's
        device."""
        return self.mesh[0]

    # -- live updates ----------------------------------------------------------
    def with_artifact(self, artifact) -> "ShardedArtifact":
        """A wrapper serving ``artifact`` that shares this wrapper's mesh
        and replica cache: the new artifact is copied to the mesh's other
        devices once, here; this wrapper keeps serving its own artifact
        (queries in flight against it finish on the old generation)."""
        if isinstance(artifact, ShardedArtifact):
            raise TypeError("artifact is already sharded")
        new = ShardedArtifact.__new__(ShardedArtifact)
        new.artifact = artifact
        new.mesh = self.mesh
        new.n_devices = self.n_devices
        new._replicas = self._replicas
        new._replicas.of(artifact, set(self.mesh))
        return new

    def refresh(self, model) -> "ShardedArtifact":
        """Re-freeze the wrapped artifact from an updated model, keeping
        this wrapper's mesh and replica cache."""
        return self.with_artifact(self.artifact.refresh(model))

    @property
    def swap_signature(self) -> tuple:
        """The wrapped artifact's signature plus the mesh."""
        return self.artifact.swap_signature + (
            ("mesh", tuple(str(d) for d in self.mesh)),)

    # -- sharded dispatch ------------------------------------------------------
    def _call(self, method: str, feats, *extra):
        """Pad the rows to a multiple of the shard count, cut them into
        contiguous equal shards in mesh order, run ``method`` of each
        shard's replica on its device, gather the outputs in shard order on
        the first device and drop the padded tail. No host sync between
        shards: each launch is enqueued on its device's stream."""
        n = int(feats.shape[0])
        rows = round_up(max(n, 1), self.n_devices) // self.n_devices
        x = pad_rows(feats, rows * self.n_devices)
        reps = self._replicas.of(self.artifact, set(self.mesh))
        outs = []
        for i, dev in enumerate(self.mesh):
            art = reps.get(dev, self.artifact)
            shard = on_device(x[i * rows:(i + 1) * rows], dev)
            outs.append(getattr(art, method)(shard, *extra))
        return _trim(_cat(outs, self.mesh[0]), n)

    # -- protocol surface ------------------------------------------------------
    def predict(self, feats) -> torch.Tensor:
        return self._call("predict", feats)

    def predict_features(self, feats) -> torch.Tensor:
        return self._call("predict_features", feats)

    def predict_query(self, q) -> torch.Tensor:
        return self._call("predict_query", q)

    def predict_topk(self, feats, k: int):
        """Sharded top-k serving (backends with ``predict_topk``): the
        wrapped artifact's ((B, k) classes, (B, k) centroid ids, (B, k)
        sims) triple, equal to the single-device call."""
        return self._call("predict_topk", feats, int(k))

    def score(self, feats, labels, batch: int = 4096) -> float:
        from repro_torch.core import evaluate as eval_lib
        return eval_lib.batched_accuracy(
            self.predict, on_device(feats, self.device),
            on_device(labels, self.device), batch)

    @property
    def row_multiple(self) -> int:
        """Rows per batch must divide into this many equal shards."""
        return self.n_devices
