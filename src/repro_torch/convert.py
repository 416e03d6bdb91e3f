"""Carry weights across: numpy arrays -> the port's ``MemhdModel``,
``MemhdTrainState``, ``HierarchicalMemhd``, ``BaselineModel`` and LM
params.

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
    dep = hierarchical_from_numpy(
        {"projection": proj},
        {"super_packed_t": spt, "am_slab_t": slab, "col_ids": ids,
         "tile_start": ts, "tile_count": tc, "centroid_class": cc},
        dataclasses.asdict(enc_cfg), dataclasses.asdict(am_cfg),
        shortlist=8, device="cpu")
    base = baseline_from_numpy(
        {"ids": ids, "levels": levels}, am, owners,          # (M, D), (M,)
        dataclasses.asdict(baseline_cfg), device="cpu")
    lm_params = lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, device="cpu")
    opt_state = adamw_state_from_numpy(
        jax.tree.map(np.asarray, opt_state), lm_params)
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

    ``enc_params`` holds the (f, D) float32 ``projection``, or the
    ``id_level`` encoder's (f, D) ``ids`` and (L, D) ``levels``;
    ``am_state`` the (C, D) float32 ``fp`` and ``binary`` AMs and the (C,)
    int32 ``centroid_class``.
    """
    device = resolve_device(device)
    return MemhdModel(_enc_params(enc_params, device),
                      _am_state(am_state, device),
                      EncoderConfig(**enc_cfg), MemhdConfig(**am_cfg))


def baseline_from_numpy(enc_params: Mapping[str, np.ndarray],
                        am: np.ndarray, owners: np.ndarray,
                        cfg: Mapping, *, device=None):
    """The port's ``BaselineModel`` from a reference baseline's arrays:
    its encoder params (``projection``, or ``ids`` and ``levels``), the
    (M, D) bipolar ``am``, the (M,) ``owners`` and the plain-dict
    ``BaselineConfig``; the encoder config follows from the kind and the
    params' shapes, as the reference's ``_encoder_cfg``."""
    from repro_torch.core.baselines import BaselineModel, _encoder_cfg
    from repro_torch.core.types import BaselineConfig
    device = resolve_device(device)
    cfg = BaselineConfig(**cfg)
    params = _enc_params(enc_params, device)
    features = next(iter(params.values())).shape[0]  # f of (f, D)
    return BaselineModel(cfg, _encoder_cfg(cfg, features), params,
                         _f32(am, device),
                         torch.tensor(np.asarray(owners, np.int32),
                                      device=device))


def train_state_from_numpy(am_state: Mapping[str, np.ndarray], epoch: int,
                           *, device=None) -> MemhdTrainState:
    """The port's ``MemhdTrainState`` from a reference training state's
    AM arrays and epoch (``fit(ckpt=...)`` and the trainer resume from
    it once a ``CheckpointManager`` has saved it)."""
    device = resolve_device(device)
    return MemhdTrainState.create(_am_state(am_state, device), int(epoch))


def hierarchical_from_numpy(enc_params: Mapping[str, np.ndarray],
                            leaves: Mapping[str, np.ndarray],
                            enc_cfg: Mapping, am_cfg: Mapping, *,
                            shortlist: int | None = None, device=None):
    """The port's ``HierarchicalMemhd`` from a reference artifact's leaves:
    ``super_packed_t`` (Dp, G) uint8, the layout's ``am_slab_t`` (Dp, Ctot)
    uint8, ``col_ids`` (Ctot,), ``tile_start`` / ``tile_count`` (G,) and
    ``centroid_class`` (C,), so both packages serve one identical layout.
    G is the length of ``tile_start``; S defaults to G."""
    from repro_torch.deploy.hierarchical import (
        ClusterLayout, artifact_from_layout,
    )
    device = resolve_device(device)
    tile_count = np.asarray(leaves["tile_count"], np.int32)
    layout = ClusterLayout(
        slab=np.asarray(leaves["am_slab_t"], np.uint8),
        col_ids=np.asarray(leaves["col_ids"], np.int32),
        tile_start=np.asarray(leaves["tile_start"], np.int32),
        tile_count=tile_count,
        max_tiles=int(tile_count.max()) if tile_count.size else 1)
    return artifact_from_layout(
        {"projection": _f32(enc_params["projection"], device)},
        np.asarray(leaves["super_packed_t"], np.uint8), layout,
        np.asarray(leaves["centroid_class"], np.int32),
        EncoderConfig(**enc_cfg), MemhdConfig(**am_cfg),
        shortlist=shortlist, device=device)


def _enc_params(enc_params: Mapping[str, np.ndarray], device) -> dict:
    keys = (("projection",) if "projection" in enc_params
            else ("ids", "levels"))
    return {k: _f32(enc_params[k], device) for k in keys}


def _f32(a, device) -> torch.Tensor:
    # A copy: the port never aliases the caller's arrays.
    return torch.tensor(np.asarray(a, np.float32), device=device)


def _am_state(am_state: Mapping[str, np.ndarray], device) -> dict:
    return {"fp": _f32(am_state["fp"], device),
            "binary": _f32(am_state["binary"], device),
            "centroid_class": torch.tensor(
                np.asarray(am_state["centroid_class"], np.int32),
                device=device)}


def lm_params_from_numpy(params, cfg, *, device=None) -> dict:
    """The port's LM params from the reference's param tree with numpy
    leaves (``T.init_params(key, cfg)[0]`` mapped through ``np.asarray``).

    The tree keeps its structure: dicts stay dicts, the ``groups`` list
    stays a list of dicts whose leaves are stacked along the group's
    ``repeat`` axis (MLA, MoE with its router and ``router_bias``,
    ``xattn``), beside ``codebook_heads``, ``patch_proj`` and the ``mtp``
    block where the config has them. Dtypes are kept: a bfloat16 leaf
    (numpy's ``ml_dtypes.bfloat16``) becomes a ``torch.bfloat16`` tensor
    bit for bit, and the float32 routers stay float32. ``cfg`` is the
    port's ``ModelConfig`` (``repro_torch.configs``).
    """
    from repro_torch.models import transformer as T
    device = resolve_device(device)
    T.check_supported(cfg)
    if len(params["groups"]) != len(cfg.blocks):
        raise ValueError(f"{len(params['groups'])} param groups for "
                         f"{len(cfg.blocks)} block groups")
    if bool(cfg.mtp_depth) != ("mtp" in params):
        raise ValueError(f"mtp_depth {cfg.mtp_depth} but the params "
                         f"{'have' if 'mtp' in params else 'lack'} an "
                         f"mtp block")
    out = _lm_tree(params, device)
    for b, g in zip(cfg.blocks, out["groups"]):
        if g["ln1"].shape[0] != b.repeat:
            raise ValueError(f"a group of {b.repeat} layers has params "
                             f"stacked {g['ln1'].shape[0]} deep")
    return out


def _lm_tree(tree, device):
    if isinstance(tree, Mapping):
        return {k: _lm_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_lm_tree(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def adamw_state_from_numpy(state, params_like) -> dict:
    """The port's AdamW state from the reference's (``adamw_init`` /
    ``adamw_update`` output with numpy leaves): {"m", "v", "step"}, where
    ``m`` and ``v`` follow the param tree and an int8 ``v`` leaf is a
    (q, scale) tuple. Leaves land on the device of the matching leaf of
    ``params_like`` (the port's params) with their own dtypes (a bfloat16
    moment bit for bit); ``step`` on the first leaf's device."""
    from repro_torch.optim.adamw import tree_leaves, tree_map

    def on(p, a):
        if isinstance(a, tuple):
            return tuple(_lm_tree(x, p.device) for x in a)
        return _lm_tree(a, p.device)

    device = tree_leaves(params_like)[0].device
    return {"m": tree_map(on, params_like, state["m"]),
            "v": tree_map(on, params_like, state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
