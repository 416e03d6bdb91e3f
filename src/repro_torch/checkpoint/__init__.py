"""Atomic, content-verified checkpoints (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointConfig, CheckpointManager,
)
