"""MEMHD core, ported to PyTorch: the paper's contribution as modules."""
from repro_torch.core.types import (  # noqa: F401
    BaselineConfig, DatasetSpec, EncoderConfig, ImcArrayConfig,
    ImcSimConfig, MemhdConfig, dataset_spec,
)
from repro_torch.core.memhd import MemhdModel, MemhdTrainState  # noqa: F401
from repro_torch.core.baselines import (  # noqa: F401
    BaselineDraws, BaselineModel, fit_baseline,
)
from repro_torch.core import (  # noqa: F401
    am, baselines, encoding, evaluate, init, kmeans, qail,
)
