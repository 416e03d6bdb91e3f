"""Digital deployment backends: packed 1-bit and unpacked float search.

Port of ``repro.deploy.digital``. ``DeployedMemhd`` is the frozen
digital serving artifact of a trained model (§III-D): the binary AM is
resident on the device and queried one-shot. Two registry targets share
the class:

* ``"packed"`` — the (Dp, C) uint8 residence (1 bit/cell, the Table-I
  accounting) searched by the ``am_search_packed`` CUDA kernel, in
  ``mode="popcount"`` (XOR + popcount) or ``mode="unpack"`` (±1 float
  dot over the unpacked bits). ``predict_features`` is the fused
  raw-feature pipeline: the ``encode_pack`` kernel chained into the
  packed search, with no float hypervector in device memory.
* ``"unpacked"`` — the ±1 float32 (C, D) residence searched by the
  ``am_search`` CUDA kernel; the parity baseline.

Predictions are identical across targets and modes (and with
``MemhdModel.predict``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import on_device
from repro_torch.core.types import EncoderConfig, MemhdConfig
from repro_torch.deploy.base import DeployedArtifact
from repro_torch.deploy.registry import register_backend
from repro_torch.kernels.am_search_packed import MODES
from repro_torch.obs.trace import traced


@dataclasses.dataclass(frozen=True)
class DeployedMemhd(DeployedArtifact):
    """Frozen digital serving artifact (packed or unpacked residence)."""

    enc_params: Dict[str, torch.Tensor]
    am_binary: Optional[torch.Tensor]    # (C, D) float32, unpacked
    am_packed_t: Optional[torch.Tensor]  # (Dp, C) uint8, packed
    centroid_class: torch.Tensor         # (C,) int32
    enc_cfg: EncoderConfig
    am_cfg: MemhdConfig
    packed: bool = True
    mode: str = "popcount"               # packed kernel: popcount | unpack

    def predict_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, D) bipolar queries -> (B,) predicted class."""
        from repro_torch.kernels import ops
        if self.packed:
            return ops.predict_packed(q, self.am_packed_t,
                                      self.centroid_class,
                                      n_dims=self.am_cfg.dim, mode=self.mode)
        return ops.predict_classes(q, self.am_binary, self.centroid_class)

    @property
    def fusable(self) -> bool:
        """True when the fused pipeline applies: packed residence,
        projection encoder and binarized queries."""
        return (self.packed and self.enc_cfg.kind == "projection"
                and self.enc_cfg.binarize_query)

    @traced("serve.predict_features", batch_arg=1)
    def predict_features(self, feats) -> torch.Tensor:
        """(B, f) raw features -> (B,) classes: fused encode/sign/pack
        kernel chained into the packed search; bit-exact with the staged
        ``predict``. Artifacts the fused kernel cannot serve (unpacked
        residence, un-binarized queries) take the staged path."""
        from repro_torch.kernels import ops
        if not self.fusable:
            return self.predict(feats)
        feats = on_device(feats, self.device)
        return ops.predict_from_features(
            feats, self.enc_params["projection"], self.am_packed_t,
            self.centroid_class, mode=self.mode)

    def refresh(self, model) -> "DeployedMemhd":
        """Re-freeze from an updated model: rewrite the resident buffers,
        keep the target and mode."""
        return _freeze(model, packed=self.packed, mode=self.mode)

    @property
    def backend(self) -> str:
        return "packed" if self.packed else "unpacked"

    @property
    def serving_mode(self) -> str:
        return self.mode if self.packed else "float"

    @property
    def resident_bytes(self) -> int:
        if self.packed:
            return int(self.am_packed_t.numel())  # uint8
        return int(self.am_binary.numel() * self.am_binary.element_size())


def _freeze(model, *, packed: bool, mode: str) -> DeployedMemhd:
    from repro_torch.core import am as am_lib
    if mode not in MODES:
        raise ValueError(f"bad mode: {mode!r}")
    binary = model.am_state["binary"]
    return DeployedMemhd(
        enc_params=model.enc_params,
        am_binary=None if packed else binary,
        am_packed_t=am_lib.pack_am(binary) if packed else None,
        centroid_class=model.am_state["centroid_class"],
        enc_cfg=model.enc_cfg, am_cfg=model.am_cfg,
        packed=packed, mode=mode)


@register_backend("packed")
def deploy_packed(model, *, mode: str = "popcount") -> DeployedMemhd:
    """Pack the binary AM 8 cells/byte; serve via the packed search."""
    return _freeze(model, packed=True, mode=mode)


@register_backend("unpacked")
def deploy_unpacked(model, *, mode: str = "popcount") -> DeployedMemhd:
    """Keep the ±1 float AM; serve via the ``am_search`` kernel."""
    return _freeze(model, packed=False, mode=mode)
