"""Architecture & input-shape registry — the 40 dry-run cells.

Each architecture module registers a full config (the exact published
numbers) and a reduced smoke config (same family, CPU-runnable). Shapes
are the four assigned input geometries; ``cell_applicable`` encodes the
skip rules (long_500k only for sub-quadratic stacks — see DESIGN.md
§Arch-applicability).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCHS: Tuple[str, ...] = (
    "hymba-1.5b",
    "qwen1.5-32b",
    "nemotron-4-340b",
    "gemma3-12b",
    "granite-20b",
    "musicgen-medium",
    "deepseek-v2-lite-16b",
    "deepseek-v3-671b",
    "internvl2-2b",
    "mamba2-130m",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "train"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Archs whose stack is sub-quadratic enough for the 500k-decode cell:
# SSM, hybrid, and the 5:1-local gemma3 (8/48 global layers hold the long
# KV; every decode step is linear in S). Pure full-attention stacks skip.
_SUBQUADRATIC = {"mamba2-130m", "hymba-1.5b", "gemma3-12b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _SUBQUADRATIC
    return True


def cells(include_skipped: bool = False):
    """Yield (arch, shape) cells; skipped ones only if requested."""
    for arch in ARCHS:
        for shape in SHAPES:
            if include_skipped or cell_applicable(arch, shape):
                yield arch, shape


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = _module(name).config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def get_smoke_config(name: str, **overrides) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    cfg = _module(name).smoke_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def shape_spec(name: str) -> ShapeSpec:
    return SHAPES[name]


def list_archs() -> Tuple[str, ...]:
    return ARCHS
