"""HDC classification datasets: real loaders + structure-faithful synthetics.

Port of ``repro.data.hdc``. The arrays are generated in numpy with the
same ``np.random.default_rng(seed + name_salt)`` stream as the
reference, so a synthetic dataset is bit-identical to the JAX package's;
only the final container differs (torch tensors on ``device``).

1. Real data is read from ``$MEMHD_DATA_DIR/<name>.npz`` (keys:
   train_x/train_y/test_x/test_y, features flattened, values in [0,1]);
2. otherwise a *synthetic* dataset faithful to the real dataset's
   structure is generated: feature count, class count, per-class sample
   counts, and intra-class **multi-modality** (each class is a mixture of
   latent "styles" — what MEMHD's multi-centroid AM exists to capture).

Every bundle carries ``source`` ("real" or "synthetic").
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.types import DatasetSpec, dataset_spec

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DataBundle:
    name: str
    train_x: torch.Tensor  # (n_train, f) float32 in [0, 1]
    train_y: torch.Tensor  # (n_train,) int32
    test_x: torch.Tensor
    test_y: torch.Tensor
    spec: DatasetSpec
    source: str  # "real" | "synthetic"

    @property
    def features(self) -> int:
        return self.train_x.shape[-1]

    @property
    def classes(self) -> int:
        return self.spec.classes


def _bundle(name, spec, source, device, train_x, train_y, test_x, test_y):
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return DataBundle(name=name, train_x=f32(train_x), train_y=i32(train_y),
                      test_x=f32(test_x), test_y=i32(test_y), spec=spec,
                      source=source)


def _try_real(name: str, spec: DatasetSpec,
              device: torch.device) -> Optional[DataBundle]:
    root = os.environ.get("MEMHD_DATA_DIR", "")
    if not root:
        return None
    path = os.path.join(root, f"{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        bundle = _bundle(name, spec, "real", device, z["train_x"],
                         z["train_y"], z["test_x"], z["test_y"])
    log.info("loaded real dataset %s from %s", name, path)
    return bundle


def synthesize(name: str, spec: DatasetSpec, seed: int = 0,
               train_per_class: Optional[int] = None,
               test_per_class: Optional[int] = None,
               *, device=None) -> DataBundle:
    """Mixture-of-latent-modes synthetic generator.

    Each class c has ``spec.latent_modes`` modes; each mode m is a random
    sparse "template" in feature space. A sample is its mode's template
    plus correlated noise plus a small class-common component, then
    squashed into [0, 1]. The numpy stream is the reference's, draw for
    draw, so the arrays equal ``repro.data.hdc.synthesize``'s exactly.
    """
    device = resolve_device(device)
    tr_n = train_per_class or spec.train_per_class
    te_n = test_per_class or spec.test_per_class
    # Stable per-name salt: python's hash() is randomized per process.
    name_salt = int.from_bytes(
        hashlib.sha256(name.encode()).digest()[:2], "little")
    rng = np.random.default_rng(seed + name_salt)
    f, k, m = spec.features, spec.classes, spec.latent_modes

    class_common = rng.normal(0, 0.55, (k, f)) * (rng.random((k, f)) < 0.12)
    mode_delta = rng.normal(0, 1.9, (k, m, f)) * (rng.random((k, m, f)) < 0.15)
    templates = class_common[:, None, :] + mode_delta  # (k, m, f)

    def sample(n_per_class: int) -> tuple:
        xs, ys = [], []
        for c in range(k):
            modes = rng.integers(0, m, size=n_per_class)
            base = templates[c, modes]  # (n, f)
            noise = rng.normal(0, 0.72, (n_per_class, f))
            xs.append(base + noise)
            ys.append(np.full((n_per_class,), c, np.int32))
        x = np.concatenate(xs, 0).astype(np.float32)
        y = np.concatenate(ys, 0)
        x = 1.0 / (1.0 + np.exp(-x))  # squash to [0, 1] like pixels
        perm = rng.permutation(x.shape[0])
        return x[perm], y[perm]

    train_x, train_y = sample(tr_n)
    test_x, test_y = sample(te_n)
    return _bundle(name, spec, "synthetic", device, train_x, train_y,
                   test_x, test_y)


def load_dataset(name: str, seed: int = 0,
                 train_per_class: Optional[int] = None,
                 test_per_class: Optional[int] = None,
                 *, device=None) -> DataBundle:
    """Load a dataset by name ("mnist" | "fmnist" | "isolet") onto
    ``device`` (the GPU unless ``device="cpu"``).

    Real data (``$MEMHD_DATA_DIR/<name>.npz``) is preferred; otherwise a
    structure-faithful synthetic stand-in is generated.
    ``train_per_class``/``test_per_class`` subsample (real) or resize
    (synthetic) per-class counts.
    """
    device = resolve_device(device)
    spec = dataset_spec(name)
    real = _try_real(name, spec, device)
    if real is not None:
        if train_per_class:
            real = _subsample(real, train_per_class, test_per_class)
        return real
    log.info("dataset %s: real data unavailable, synthesizing", name)
    return synthesize(name, spec, seed, train_per_class, test_per_class,
                      device=device)


def _subsample(b: DataBundle, train_per_class: int,
               test_per_class: Optional[int]) -> DataBundle:
    def pick(x, y, n_pc):
        y_np = y.cpu().numpy()
        idx = np.concatenate([np.nonzero(y_np == c)[0][:n_pc]
                              for c in range(b.spec.classes)])
        sel = torch.as_tensor(idx, device=x.device)
        return x[sel], y[sel]

    tx, ty = pick(b.train_x, b.train_y, train_per_class)
    ex, ey = ((b.test_x, b.test_y) if not test_per_class
              else pick(b.test_x, b.test_y, test_per_class))
    return dataclasses.replace(b, train_x=tx, train_y=ty,
                               test_x=ex, test_y=ey)
