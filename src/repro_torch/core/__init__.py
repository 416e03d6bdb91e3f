"""MEMHD core, ported to PyTorch: the paper's contribution as modules."""
from repro_torch.core.types import (  # noqa: F401
    BaselineConfig, DatasetSpec, EncoderConfig, ImcArrayConfig,
    ImcSimConfig, MemhdConfig, dataset_spec,
)
from repro_torch.core.memhd import MemhdModel  # noqa: F401
from repro_torch.core import (  # noqa: F401
    am, encoding, evaluate, init, kmeans, qail,
)
