"""Deterministic, checkpointable LM token pipeline.

The port's own copy of ``repro.data.lm`` (numpy, host side): a Zipfian
token stream with periodic motif re-use, fully deterministic in
(seed, position), so ``next_batch`` gives the reference's arrays bit for
bit:

    state = PipelineState(seed, position)
    batch, state = next_batch(cfg, state)

``PipelineState`` is two integers; it rides in the checkpoint manifest so
a restart resumes the exact stream position. The trainer moves the numpy
batch to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class LmDataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    # Zipf exponent for the unigram skeleton; motifs add burstiness.
    zipf_a: float = 1.2
    motif_len: int = 16
    motif_count: int = 512


@dataclasses.dataclass(frozen=True)
class PipelineState:
    seed: int = 0
    position: int = 0  # batches already emitted

    def to_json(self) -> dict:
        return {"seed": self.seed, "position": self.position}

    @classmethod
    def from_json(cls, d: dict) -> "PipelineState":
        return cls(seed=int(d["seed"]), position=int(d["position"]))


def _motifs(cfg: LmDataConfig, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed ^ 0x5EED)
    # Motifs come from the mid-frequency band: learnable, but not
    # predicted by unigram statistics alone.
    return rng.integers(cfg.vocab_size // 16, cfg.vocab_size // 2,
                        size=(cfg.motif_count, cfg.motif_len))


def next_batch(cfg: LmDataConfig, state: PipelineState,
               ) -> Tuple[dict, PipelineState]:
    """Produce {tokens, targets} and the next state.

    tokens/targets: (global_batch, seq_len) int32 numpy arrays, targets =
    tokens shifted left (next-token prediction).
    """
    rng = np.random.default_rng((state.seed * 1_000_003 + state.position))
    motifs = _motifs(cfg, state.seed)

    b, s = cfg.global_batch, cfg.seq_len
    # Zipf skeleton (clipped into vocab range).
    toks = rng.zipf(cfg.zipf_a, size=(b, s + 1)).astype(np.int64)
    toks = np.clip(toks, 1, cfg.vocab_size - 1)
    # Paste motifs at random offsets: ~25% of positions get motif content,
    # giving in-context copy structure for attention/SSM to learn.
    n_paste = max(1, (s // cfg.motif_len) // 4)
    for row in range(b):
        ids = rng.integers(0, cfg.motif_count, size=n_paste)
        offs = rng.integers(0, s + 1 - cfg.motif_len, size=n_paste)
        for m, o in zip(ids, offs):
            toks[row, o:o + cfg.motif_len] = motifs[m]
    toks = toks.astype(np.int32)
    return ({"tokens": toks[:, :-1], "targets": toks[:, 1:]},
            PipelineState(state.seed, state.position + 1))
