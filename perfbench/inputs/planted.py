"""A huge-label AM planted around prototypes, queried through the encoder.

The recipe of the repo's huge-label point (``benchmarks/
hierarchical_search.py``: C = 100,000 columns around 316 prototypes with
8 % of each column's bits flipped), restated for raw features, since
every cell here serves feature rows through the projection encoder.

A prototype is a dense Gaussian template in feature space (``template``
sigma); its hypervector is the sign of the projected ``tanh`` of the
template. Column i copies the hypervector of a uniformly drawn prototype
with each bit flipped with probability ``column_flip``; it is its own
class (one column per class). A feature row is ``tanh(template + noise *
z)`` of a uniformly drawn prototype, rounded down to the ``feature_bits``
grid; at noise 0.3 its query differs from its prototype's hypervector in
about 10 % of the bits, the reference recipe's query flip rate.
"""
from __future__ import annotations

import torch

from perfbench.inputs import Inputs, bipolar, dyadic

CHUNK = 16384  # columns drawn per step, so the flip field stays small


def build(cfg: dict, gen: torch.Generator) -> Inputs:
    data = cfg["data"]
    f, d, c = cfg["features"], cfg["dim"], cfg["columns"]
    p = data["prototypes"]
    dev = gen.device
    projection = bipolar(gen, (f, d))
    templates = torch.randn((p, f), generator=gen, device=dev) * data[
        "template"]
    protos = torch.where(torch.tanh(templates) @ projection >= 0, 1.0, -1.0)
    src = torch.randint(0, p, (c,), generator=gen, device=dev)
    am = torch.empty((c, d), device=dev)
    for i in range(0, c, CHUNK):
        blk = protos[src[i:i + CHUNK]]
        flip = torch.rand(blk.shape, generator=gen, device=dev) < data[
            "column_flip"]
        am[i:i + CHUNK] = torch.where(flip, -blk, blk)
    owners = torch.arange(c, dtype=torch.int32, device=dev)

    def sample(n: int) -> torch.Tensor:
        which = torch.randint(0, p, (n,), generator=gen, device=dev)
        z = torch.randn((n, f), generator=gen, device=dev)
        x = torch.tanh(templates[which] + data["noise"] * z)
        return dyadic(x, data["feature_bits"])

    return Inputs(projection, am, owners, sample)
