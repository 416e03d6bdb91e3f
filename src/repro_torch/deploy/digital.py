"""Packed 1-bit digital deployment (port of ``repro.deploy.digital``).

``DeployedMemhd`` is the frozen serving artifact of a trained model
(§III-D): the (Dp, C) uint8 packed binary AM (1 bit/cell, the Table-I
accounting) is resident on the device and searched by the XOR+popcount
CUDA kernel. ``predict_features`` is the fused raw-feature pipeline: the
``encode_pack`` kernel chained into the packed search, with no float
hypervector in device memory. The ``"unpacked"`` target waits for the
``am_search`` kernel (ROADMAP queue 2, item 3) and is not registered.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import on_device
from repro_torch.core.types import EncoderConfig, MemhdConfig
from repro_torch.deploy.base import DeployedArtifact
from repro_torch.deploy.registry import register_backend


@dataclasses.dataclass(frozen=True)
class DeployedMemhd(DeployedArtifact):
    """Frozen packed serving artifact."""

    enc_params: Dict[str, torch.Tensor]
    am_packed_t: torch.Tensor      # (Dp, C) uint8
    centroid_class: torch.Tensor   # (C,) int32
    enc_cfg: EncoderConfig
    am_cfg: MemhdConfig
    mode: str = "popcount"

    packed = True

    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) predicted class."""
        from repro_torch.kernels import ops
        return ops.predict_packed(q, self.am_packed_t, self.centroid_class,
                                  n_dims=self.am_cfg.dim, mode=self.mode)

    @property
    def fusable(self) -> bool:
        """True when the fused pipeline applies: projection encoder and
        binarized queries."""
        return (self.enc_cfg.kind == "projection"
                and self.enc_cfg.binarize_query)

    def predict_features(self, feats) -> torch.Tensor:
        """(B, f) raw features -> (B,) classes: fused encode/sign/pack
        kernel chained into the packed search; bit-exact with the staged
        ``predict``."""
        from repro_torch.kernels import ops
        if not self.fusable:
            return self.predict(feats)
        feats = on_device(feats, self.device)
        return ops.predict_from_features(
            feats, self.enc_params["projection"], self.am_packed_t,
            self.centroid_class, mode=self.mode)

    @property
    def backend(self) -> str:
        return "packed"

    @property
    def serving_mode(self) -> str:
        return self.mode

    @property
    def resident_bytes(self) -> int:
        return int(self.am_packed_t.numel())  # uint8


@register_backend("packed")
def deploy_packed(model, *, mode: str = "popcount") -> DeployedMemhd:
    """Pack the binary AM 8 cells/byte; serve via XOR+popcount."""
    from repro_torch.core import am as am_lib
    if mode == "unpack":
        raise NotImplementedError(
            'mode="unpack" is not ported yet (ROADMAP queue 2, item 4)')
    if mode != "popcount":
        raise ValueError(f"bad mode: {mode!r}")
    return DeployedMemhd(
        enc_params=model.enc_params,
        am_packed_t=am_lib.pack_am(model.am_state["binary"]),
        centroid_class=model.am_state["centroid_class"],
        enc_cfg=model.enc_cfg, am_cfg=model.am_cfg, mode=mode)
