from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, SHAPES, get_config, get_smoke_config, list_archs, shape_spec,
    cells, cell_applicable,
)
