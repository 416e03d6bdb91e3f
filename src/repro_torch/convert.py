"""Carry weights across: numpy arrays -> the port's ``MemhdModel`` and
``MemhdTrainState``.

The parity tests build a model (or a training state) in the JAX package,
pull its arrays to numpy on that side, and hand them here, so the port
never sees a jax object:

    model = model_from_numpy(
        {"projection": proj},                                # (f, D)
        {"fp": fp, "binary": binary, "centroid_class": cc},  # (C, D), (C,)
        dataclasses.asdict(enc_cfg), dataclasses.asdict(am_cfg),
        device="cpu")
    state = train_state_from_numpy(
        {"fp": fp, "binary": binary, "centroid_class": cc}, epoch=3,
        device="cpu")
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.memhd import MemhdModel, MemhdTrainState
from repro_torch.core.types import EncoderConfig, MemhdConfig


def model_from_numpy(enc_params: Mapping[str, np.ndarray],
                     am_state: Mapping[str, np.ndarray],
                     enc_cfg: Mapping, am_cfg: Mapping, *,
                     device=None) -> MemhdModel:
    """Build the port's model from numpy weights and plain-dict configs.

    ``enc_params`` holds the (f, D) float32 ``projection``; ``am_state``
    the (C, D) float32 ``fp`` and ``binary`` AMs and the (C,) int32
    ``centroid_class``.
    """
    device = resolve_device(device)
    return MemhdModel({"projection": _f32(enc_params["projection"], device)},
                      _am_state(am_state, device),
                      EncoderConfig(**enc_cfg), MemhdConfig(**am_cfg))


def train_state_from_numpy(am_state: Mapping[str, np.ndarray], epoch: int,
                           *, device=None) -> MemhdTrainState:
    """The port's ``MemhdTrainState`` from a reference training state's
    AM arrays and epoch (``fit(ckpt=...)`` and the trainer resume from
    it once a ``CheckpointManager`` has saved it)."""
    device = resolve_device(device)
    return MemhdTrainState.create(_am_state(am_state, device), int(epoch))


def _f32(a, device) -> torch.Tensor:
    # A copy: the port never aliases the caller's arrays.
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _am_state(am_state: Mapping[str, np.ndarray], device) -> dict:
    return {"fp": _f32(am_state["fp"], device),
            "binary": _f32(am_state["binary"], device),
            "centroid_class": torch.tensor(
                np.asarray(am_state["centroid_class"], np.int32),
                device=device)}
