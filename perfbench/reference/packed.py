"""Reference of the digital artifact (``target="packed"``): an exact search.

Every query is compared with every column; the answer is the class of
the most similar column, the first (lowest id) on ties. Similarities of
±1 rows are integers below 2**24, so the float32 product is exact in any
order and in TF32 too: the control differs only in the encoder.
"""
from __future__ import annotations

import torch

from perfbench import reference as ref

BLOCK = 1 << 28  # elements of one (rows, C) similarity block


def prepare(inputs, opts: dict, seed: int) -> dict:
    return {"projection": inputs.projection, "am_t": inputs.am.T,
            "owners": inputs.owners}


def answers(state: dict, feats: torch.Tensor, route: dict,
            lower: bool = False) -> tuple[tuple, dict]:
    if route["call"] != "predict_features":
        raise ValueError(f"packed: no reference for {route['call']!r}")
    q = ref.queries(feats, state["projection"], lower)
    c = state["am_t"].shape[1]
    rows = max(1, BLOCK // c)
    best = torch.cat([torch.argmax(ref.matmul(q[i:i + rows], state["am_t"],
                                              lower), dim=-1)
                      for i in range(0, q.shape[0], rows)])
    return (state["owners"][best],), {"columns": q.shape[0] * c}
