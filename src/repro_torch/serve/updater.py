"""``StreamingUpdater``: live class-incremental AM updates mid-serving.

Port of ``repro.serve.updater``. The updater owns the *trainable* side
of an online deployment: the live ``MemhdModel`` (with its float shadow
AM — the deployed artifact alone cannot learn) plus a bounded buffer of
labeled feedback. ``fold()`` turns the buffer into a new model
generation and a new serving artifact:

1. **grow** — feedback labeled with never-seen classes first grows the
   AM ``(C, D) -> (C + k, D)`` via ``MemhdModel.grow_classes`` (growth
   must precede the fold: QAIL's ownership-masked Eq.-(5) corrupts
   updates for labels owning no centroid);
2. **fold** — the whole buffer runs through the QAIL epochs
   (``qail.fold_feedback``: the float shadow updated, the binary AM
   re-binarized); on the GPU every minibatch is one ``qail_update``
   kernel launch;
3. **re-freeze** — the served artifact is rebuilt from the new model
   through ``DeployedArtifact.refresh``: a same-C fold keeps every
   tensor's shape and every static field (``swap_signature`` equal:
   the swap reuses every launch plan and scratch), class growth
   re-deploys at the new geometry.

Before the new artifact is published, the updater synchronizes the
stream its buffers were written on, so the swap never publishes pending
work. The engine swaps it in as a reference replacement; artifacts are
immutable, and the old generation stays intact for batches already
launched against it.

Observability: ``model_generation`` gauge, ``update_fold_ms``
histogram, and one structured event per generation through an optional
``obs.EventLog``.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import obs

log = logging.getLogger("serve.updater")


@dataclasses.dataclass(frozen=True)
class UpdateResult:
    """What one ``fold()`` produced."""

    generation: int        # the new model generation (starts at 1)
    artifact: Any          # the re-frozen serving artifact
    shape_stable: bool     # True -> equal swap_signature, plans reused
    fold_ms: float         # wall time of grow + fold + re-freeze
    n_samples: int         # feedback rows folded
    n_new_classes: int     # classes appended by this fold
    miss_rate: float       # QAIL miss rate over the buffer (last epoch)


class StreamingUpdater:
    """Accepts labeled feedback mid-serving and folds it into the AM.

    Args:
      model: the live ``MemhdModel`` (must carry the float shadow AM the
        deployment was frozen from — QAIL updates land on it).
      artifact: the currently-served artifact built from ``model``.
      fold_epochs: QAIL epochs per fold (1 is the streaming default; the
        buffer is small, more epochs overfit it).
      fold_every: auto-fold once the buffer holds this many samples
        (None = only explicit ``fold()`` calls / forced feedback).
      buffer_cap: drop-oldest bound on buffered feedback rows.
      use_kernel: fold through the ``qail_update`` kernel; None (the
        default) means the kernel when the model is on the GPU and the
        plain path on the CPU.
      events: optional ``obs.EventLog`` for per-generation records.
    """

    def __init__(self, model, artifact, *, fold_epochs: int = 1,
                 fold_every: Optional[int] = None,
                 buffer_cap: int = 4096,
                 use_kernel: Optional[bool] = None,
                 events: Optional[obs.EventLog] = None):
        if fold_epochs < 1:
            raise ValueError("fold_epochs must be >= 1")
        if buffer_cap < 1:
            raise ValueError("buffer_cap must be >= 1")
        self.model = model
        self.artifact = artifact
        self.generation = 0
        self.fold_epochs = fold_epochs
        self.fold_every = fold_every
        self.buffer_cap = buffer_cap
        self.use_kernel = use_kernel
        self.events = events or obs.EventLog(None)
        self._feats: List[np.ndarray] = []
        self._labels: List[np.ndarray] = []
        self._buffered = 0
        self._gen_gauge = obs.gauge(
            "model_generation", "current served model generation")
        self._fold_hist = obs.histogram(
            "update_fold_ms", "wall ms per feedback fold "
            "(grow + QAIL scan + artifact re-freeze)")
        self._gen_gauge.set(0)

    # -- feedback intake ------------------------------------------------------
    @property
    def buffered(self) -> int:
        """Feedback rows currently buffered."""
        return self._buffered

    def ingest(self, feats, labels) -> None:
        """Buffer labeled feedback (drop-oldest beyond ``buffer_cap``)."""
        feats = np.asarray(feats)
        labels = np.asarray(labels)
        if feats.shape[0] != labels.shape[0]:
            raise ValueError("feats/labels length mismatch")
        if feats.shape[0] == 0:
            return
        self._feats.append(feats)
        self._labels.append(labels)
        self._buffered += feats.shape[0]
        while self._buffered > self.buffer_cap and len(self._feats) > 1:
            self._buffered -= self._feats.pop(0).shape[0]
            self._labels.pop(0)
        if self._buffered > self.buffer_cap:  # single oversized chunk
            keep = self.buffer_cap
            self._feats[0] = self._feats[0][-keep:]
            self._labels[0] = self._labels[0][-keep:]
            self._buffered = keep

    @property
    def should_fold(self) -> bool:
        """Buffer policy: has the auto-fold threshold been reached?"""
        return (self.fold_every is not None
                and self._buffered >= self.fold_every)

    # -- the fold -------------------------------------------------------------
    def fold(self) -> Optional[UpdateResult]:
        """Fold the buffered feedback into a new model generation.

        Returns the ``UpdateResult`` (the engine swaps
        ``result.artifact`` in), or None when the buffer is empty.
        Synchronizes the device before returning, so the swap never
        publishes pending work.
        """
        if self._buffered == 0:
            return None
        from repro_torch.core import encoding, qail

        feats = np.concatenate(self._feats)
        labels = np.concatenate(self._labels).astype(np.int64)
        self._feats, self._labels, self._buffered = [], [], 0

        with obs.timed_ms(self._fold_hist) as elapsed:
            model = self.model
            device = model.device
            use_kernel = (device.type == "cuda" if self.use_kernel is None
                          else self.use_kernel)
            old_classes = model.am_cfg.classes
            h = model.encode(feats)
            if int(labels.max()) >= old_classes:
                # Growth first; the encoder is untouched, so ``h`` stays
                # valid for the fold below.
                model = model.grow_classes(feats, labels, h=h)
                log.info("grew AM to C=%d (classes %d -> %d)",
                         model.am_cfg.columns, old_classes,
                         model.am_cfg.classes)
            q = encoding.binarize_query(h)
            state, miss = qail.fold_feedback(
                model.am_state, model.am_cfg, h, q,
                torch.as_tensor(labels, device=device),
                epochs=self.fold_epochs, use_kernel=use_kernel)
            model = dataclasses.replace(model, am_state=state)

            old_sig = self.artifact.swap_signature
            artifact = self.artifact.refresh(model)
            shape_stable = artifact.swap_signature == old_sig
            if device.type == "cuda":
                torch.cuda.current_stream(device).synchronize()

        self.model = model
        self.artifact = artifact
        self.generation += 1
        self._gen_gauge.set(self.generation)
        n_new = model.am_cfg.classes - old_classes
        result = UpdateResult(
            generation=self.generation, artifact=artifact,
            shape_stable=shape_stable, fold_ms=elapsed(),
            n_samples=int(labels.shape[0]), n_new_classes=n_new,
            miss_rate=miss)
        self.events.emit("model_fold", generation=self.generation,
                         fold_ms=round(result.fold_ms, 3),
                         n_samples=result.n_samples,
                         n_new_classes=n_new,
                         classes=model.am_cfg.classes,
                         columns=model.am_cfg.columns,
                         shape_stable=shape_stable,
                         miss_rate=round(miss, 4))
        log.info("generation %d: folded %d samples in %.1f ms "
                 "(new classes: %d, shape_stable: %s)",
                 self.generation, result.n_samples, result.fold_ms,
                 n_new, shape_stable)
        return result
