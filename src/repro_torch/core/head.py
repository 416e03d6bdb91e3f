"""MemhdHead — the paper's multi-centroid AM as a classification head.

Port of ``repro.core.head``. Pooled backbone features are
projection-encoded into a D-dimensional bipolar hypervector and
classified by one-shot associative search against a (C x D) binary
multi-centroid AM: the paper's pipeline with "features" = backbone
embeddings instead of pixels. It trains with the same clustering-init +
QAIL recipe and fits one 128x128 IMC array when D = C = 128.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core.memhd import GenLike, MemhdModel
from repro_torch.core.types import EncoderConfig, MemhdConfig


@dataclasses.dataclass
class MemhdHead:
    """Multi-centroid AM head over pooled backbone features."""

    model: MemhdModel

    @classmethod
    def create(cls, gen: GenLike, feature_dim: int, n_classes: int,
               dim: int = 128, columns: int = 128, *, device=None,
               **am_kwargs) -> "MemhdHead":
        enc = EncoderConfig(kind="projection", features=feature_dim,
                            dim=dim)
        am = MemhdConfig(dim=dim, columns=columns, classes=n_classes,
                         **am_kwargs)
        return cls(MemhdModel.create(gen, enc, am, device=device))

    @staticmethod
    def pool(hidden: torch.Tensor) -> torch.Tensor:
        """Mean-pool (B, S, D_model) backbone states to (B, D_model)."""
        return hidden.mean(dim=1)

    def fit(self, gen: GenLike, feats, labels, **kw,
            ) -> Tuple["MemhdHead", Dict]:
        m, hist = self.model.fit(gen, feats, labels, **kw)
        return MemhdHead(m), hist

    def predict(self, feats) -> torch.Tensor:
        return self.model.predict(feats)

    def score(self, feats, labels) -> float:
        return self.model.score(feats, labels)

    @property
    def memory_kb(self) -> float:
        return self.model.memory_kb
