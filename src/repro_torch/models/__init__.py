"""The LM stack of the port: config schema, layers, model assembly."""
from repro_torch.models.config import (  # noqa: F401
    AttnSpec, BlockSpec, FfnSpec, ModelConfig, SsmSpec,
)
from repro_torch.models import layers, transformer  # noqa: F401
