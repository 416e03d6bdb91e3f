"""One evaluator for every accuracy loop (port of ``repro.core.evaluate``).

The ragged final batch is padded up to the batch size by repeating its
last row, with padded labels -1 (no class id matches them), so the
predict function always sees one shape; per-batch correct-counts stay
on the device and are pulled to the host once.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import am as am_lib
from repro_torch.deploy.padding import pad_rows, pad_vec


def batched_accuracy(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                     inputs: torch.Tensor, labels: torch.Tensor,
                     batch: int = 4096) -> float:
    """Accuracy of ``predict_fn`` over (inputs, labels), batched + padded."""
    n = int(inputs.shape[0])
    if n == 0:
        return 0.0
    bs = min(batch, n)
    total = torch.zeros((), dtype=torch.int64, device=inputs.device)
    for b in range(0, n, bs):
        x = inputs[b:b + bs]
        y = labels[b:b + bs]
        if x.shape[0] < bs:  # pad the ragged tail to the uniform shape
            x = pad_rows(x, bs, fill="edge")
            y = pad_vec(y, bs, value=-1)
        total += (predict_fn(x).to(y.device) == y).sum()
    return int(total) / n


def am_accuracy(state, queries: torch.Tensor, labels: torch.Tensor,
                batch: int = 4096) -> float:
    """Accuracy of an AM state dict on pre-encoded (queries, labels)."""
    binary, owners = state["binary"], state["centroid_class"]
    return batched_accuracy(lambda q: am_lib.predict(binary, owners, q),
                            queries, labels, batch=batch)
