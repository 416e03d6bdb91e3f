"""``DeployedArtifact``: the deployment protocol every backend implements.

Port of ``repro.deploy.base``. A concrete artifact supplies its fields,
``predict_query`` (the backend's search), ``resident_bytes`` and the
``backend`` / ``serving_mode`` labels; the staged predict, the padded
scoring, the residence ratio, ``refresh`` and ``swap_signature`` (the
online swap's fingerprint) are written here once. Artifacts are frozen
dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import on_device
from repro_torch.obs.trace import traced


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

    @traced("serve.predict", batch_arg=1)
    def predict(self, feats) -> torch.Tensor:
        """(B, f) raw features -> (B,) classes, staged encode + search."""
        from repro_torch.core import encoding
        feats = on_device(feats, self.device)
        q = encoding.encode_query(self.enc_params, self.enc_cfg, feats)
        return self.predict_query(q)

    @traced("serve.predict_features", batch_arg=1)
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

    @property
    def swap_signature(self) -> tuple:
        """Hashable fingerprint of what a launch on this artifact sees.

        For each compared dataclass field: a tensor gives (field, shape,
        dtype, device), a dict of tensors one such entry per key, and any
        other field (configs, mode, groups, cell bits, ...) its value;
        ``n_dims`` (the AM's D) closes it. The port's launch plans are
        functions of the shapes, so two artifacts with equal signatures
        get the same plans, and swap one for the other reuses every plan
        and scratch (the reference's zero-recompile swap). A changed
        signature (class growth widened the AM) means new plans.
        """
        sig = []
        for f in dataclasses.fields(self):
            if not f.compare:
                continue
            v = getattr(self, f.name)
            if isinstance(v, dict):
                sig.extend(_leaf(f"{f.name}.{k}", t)
                           for k, t in sorted(v.items()))
            else:
                sig.append(_leaf(f.name, v))
        sig.append(("n_dims", self.am_cfg.dim))
        return tuple(sig)

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


def _leaf(name: str, v) -> tuple:
    if isinstance(v, torch.Tensor):
        return (name, tuple(v.shape), str(v.dtype), str(v.device))
    return (name, v)
