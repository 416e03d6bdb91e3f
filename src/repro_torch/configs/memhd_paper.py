"""The paper's own MEMHD operating points, as named configs.

Port of ``repro.configs.memhd_paper``: the geometries the paper
evaluates (Figs. 3–7, Table II), square DxC grids for MNIST/FMNIST,
fixed 128 columns for ISOLET, and the flagship deployment points of
Table II / Fig. 7.

    from repro_torch.configs.memhd_paper import paper_config
    enc_cfg, am_cfg = paper_config("mnist", "128x128")
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.types import EncoderConfig, MemhdConfig, dataset_spec

# Geometry grids straight from the paper's figures.
GRIDS: Dict[str, Tuple[str, ...]] = {
    "mnist": ("64x64", "128x128", "256x256", "512x512", "1024x1024"),
    "fmnist": ("64x64", "128x128", "256x256", "512x512", "1024x1024"),
    "isolet": ("128x128", "256x128", "512x128", "1024x128"),
}

# Table II / Fig. 7 flagship deployment points.
FLAGSHIP = {
    "mnist": "128x128",
    "fmnist": "128x128",
    "isolet": "512x128",
}

# Fig.-6 guidance: R ≈ 0.8–0.9 for tight column budgets; 1.0 for ISOLET.
DEFAULT_R = {"mnist": 0.8, "fmnist": 0.8, "isolet": 1.0}
# §III-C: lower lr for harder datasets / smaller D.
DEFAULT_LR = {"mnist": 0.02, "fmnist": 0.02, "isolet": 0.015}


def paper_config(dataset: str, geometry: str | None = None,
                 **overrides) -> Tuple[EncoderConfig, MemhdConfig]:
    """(EncoderConfig, MemhdConfig) for a paper operating point."""
    spec = dataset_spec(dataset)
    geometry = geometry or FLAGSHIP[dataset]
    if geometry not in GRIDS[dataset]:
        raise KeyError(
            f"{geometry!r} not a paper geometry for {dataset}: "
            f"{GRIDS[dataset]}")
    d, c = (int(x) for x in geometry.split("x"))
    enc = EncoderConfig(kind="projection", features=spec.features, dim=d)
    am_kwargs = dict(
        dim=d, columns=c, classes=spec.classes,
        init_ratio=DEFAULT_R[dataset], lr=DEFAULT_LR[dataset],
        epochs=100,  # paper: "trained for 100 epochs following init"
    )
    am_kwargs.update(overrides)
    return enc, MemhdConfig(**am_kwargs)


def list_paper_points():
    for ds, grid in GRIDS.items():
        for g in grid:
            yield ds, g
