"""``DeployedArtifact``: the deployment protocol every backend implements.

Port of ``repro.deploy.base``. A concrete artifact supplies its fields,
``predict_query`` (the backend's search), ``resident_bytes`` and the
``backend`` / ``serving_mode`` labels; the staged predict, the padded
scoring and the residence ratio are written here once.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import on_device


class DeployedArtifact:
    """Shared behaviour of every frozen MEMHD serving artifact."""

    enc_params: Any
    centroid_class: torch.Tensor
    enc_cfg: Any
    am_cfg: Any

    @property
    def device(self) -> torch.device:
        return self.centroid_class.device

    # -- inference -------------------------------------------------------------
    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) predicted class."""
        raise NotImplementedError

    def predict(self, feats) -> torch.Tensor:
        """(B, f) raw features -> (B,) classes, staged encode + search."""
        from repro_torch.core import encoding
        feats = on_device(feats, self.device)
        q = encoding.encode_query(self.enc_params, self.enc_cfg, feats)
        return self.predict_query(q)

    def predict_features(self, feats) -> torch.Tensor:
        """Raw-feature serving entry point; backends with a fused
        feature->prediction pipeline override it."""
        return self.predict(feats)

    def score(self, feats, labels, batch: int = 4096) -> float:
        """Accuracy through the shared padded evaluator."""
        from repro_torch.core import evaluate as eval_lib
        return eval_lib.batched_accuracy(
            self.predict, on_device(feats, self.device),
            on_device(labels, self.device), batch)

    def score_queries(self, q, labels, batch: int = 4096) -> float:
        """Accuracy on pre-encoded queries, same padded evaluator."""
        from repro_torch.core import evaluate as eval_lib
        return eval_lib.batched_accuracy(
            self.predict_query, on_device(q, self.device),
            on_device(labels, self.device), batch)

    # -- live updates ----------------------------------------------------------
    def _deploy_opts(self) -> dict:
        """Backend kwargs that rebuild an equivalent artifact through the
        registry; backends with deploy-time knobs override it."""
        return {}

    def refresh(self, model) -> "DeployedArtifact":
        """Re-freeze this artifact from an updated model: a new artifact
        from the registry, same target and ``_deploy_opts()``."""
        from repro_torch.deploy import registry
        return registry.deploy(model, self.backend, **self._deploy_opts())

    # -- reporting / accounting ------------------------------------------------
    @property
    def backend(self) -> str:
        """Registry target name this artifact serves under."""
        raise NotImplementedError

    @property
    def serving_mode(self) -> str:
        """Human-readable kernel/readout mode for the serving report."""
        raise NotImplementedError

    @property
    def resident_bytes(self) -> int:
        """Bytes the resident AM occupies on the device."""
        raise NotImplementedError

    @property
    def resident_am_bytes(self) -> int:
        return self.resident_bytes

    @property
    def am_memory_ratio(self) -> float:
        """Byte-per-cell residence / this artifact's resident bytes (a
        packed artifact reports ~8x)."""
        return (self.am_cfg.columns * self.am_cfg.dim) / self.resident_bytes

    def _cost_arr(self):
        """Array geometry ``imc_cost`` defaults to (backends override)."""
        from repro_torch.core.types import ImcArrayConfig
        return ImcArrayConfig()

    def imc_cost(self, arr=None):
        """Closed-form IMC mapping of this model's geometry."""
        from repro_torch.core.imc import memhd_pipeline
        return memhd_pipeline(self.enc_cfg.features, self.am_cfg.dim,
                              self.am_cfg.columns, arr or self._cost_arr())
