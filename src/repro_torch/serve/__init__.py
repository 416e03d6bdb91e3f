"""repro_torch.serve — the online serving engine (port of
``repro.serve``).

Open-loop timed serving with live class-incremental learning, built
from three pieces:

  * ``repro_torch.serve.stream`` — the event vocabulary:
    ``OnlineRequest`` / ``Arrival`` / ``Feedback``, plus Poisson arrival
    generators, feedback bursts, and deterministic drift (numpy only).
  * ``repro_torch.serve.updater`` — ``StreamingUpdater``: buffers
    labeled feedback, folds it through QAIL (the ``qail_update`` kernel
    on the GPU; growing the AM first when feedback names never-seen
    classes), and re-freezes a new immutable artifact generation per
    fold.
  * ``repro_torch.serve.engine`` — ``OnlineEngine``: deadline-aware
    adaptive batching over an admission queue, a depth-deep pipeline,
    atomic artifact swaps between generations, and per-phase rebuild
    accounting (``recompiles_steady_state`` must stay 0).

The closed-loop benchmark path stays in
``repro_torch.launch.serve_memhd``.
"""
from repro_torch.serve.engine import (
    OnlineEngine, ServiceModel, batch_buckets, plan_batch,
)
from repro_torch.serve.stream import (
    Arrival, Feedback, OnlineRequest, apply_drift, feedback_burst,
    merge_events, poisson_arrivals,
)
from repro_torch.serve.updater import StreamingUpdater, UpdateResult

__all__ = [
    "OnlineEngine", "ServiceModel", "batch_buckets", "plan_batch",
    "Arrival", "Feedback", "OnlineRequest", "apply_drift",
    "feedback_burst", "merge_events", "poisson_arrivals",
    "StreamingUpdater", "UpdateResult",
]
