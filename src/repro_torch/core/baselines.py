"""Binary-HDC baselines of Table I: BasicHDC, QuantHD, LeHDC, SearcHD.

Port of ``repro.core.baselines``. Each baseline has the same fit/score
surface as ``MemhdModel`` so the Fig.-3/7 benchmarks can sweep them
uniformly.

* **BasicHDC** — projection encoding, single-pass AM (class vector = sum
  of its samples' hypervectors), binarized.
* **QuantHD** [13] — ID-level encoding, one class vector per class,
  quantization-aware iterative learning: similarity on the binary AM,
  Eq.-(2) updates on the float AM, re-binarized each epoch.
* **LeHDC** [15] — ID-level encoding, BNN-style training: logits are
  dot-similarities of the sign-binarized class vectors (straight-through
  estimator), softmax cross-entropy, SGD with momentum on float weights.
* **SearcHD** [14] — ID-level encoding, N-vector stochastic quantization:
  per class, N binary vectors sampled from the accumulated class vector's
  per-dimension firing probability; inference = argmax over all k*N.

The fitters run where the caller asks (the GPU unless ``device="cpu"``).
Their random draws come from a ``torch.Generator``; ``draws=`` hands in
others (``BaselineDraws``: the encoder params, LeHDC's initial weights,
SearcHD's uniforms), which is how the tests cross the reference's
``jax.random`` draws. Every update is a plain PyTorch product: no
Pallas kernel stands behind these in the reference either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch import generator, on_device, resolve_device
from repro_torch.core import encoding
from repro_torch.core.types import BaselineConfig, EncoderConfig

GenLike = Union[torch.Generator, int]


@dataclasses.dataclass(frozen=True)
class BaselineDraws:
    """Random draws a fitter takes instead of drawing its own (None: draw
    it). ``enc_params``: the encoder's arrays (``projection``, or ``ids``
    and ``levels``); ``lehdc_weights``: LeHDC's (k, D) initial float
    weights (the reference's ``0.01 * normal``); ``searchd_uniforms``:
    SearcHD's (k, N, D) uniforms in [0, 1)."""

    enc_params: Optional[Mapping[str, np.ndarray]] = None
    lehdc_weights: Optional[np.ndarray] = None
    searchd_uniforms: Optional[np.ndarray] = None


def _sign(x: torch.Tensor) -> torch.Tensor:
    """sign with 0 -> +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _encoder_cfg(cfg: BaselineConfig, features: int) -> EncoderConfig:
    kind = "projection" if cfg.kind == "basic" else "id_level"
    return EncoderConfig(kind=kind, features=features, dim=cfg.dim)


@dataclasses.dataclass
class BaselineModel:
    """Uniform container: binary AM of shape (M, D) + owner classes (M,)."""

    cfg: BaselineConfig
    enc_cfg: EncoderConfig
    enc_params: Dict[str, torch.Tensor]
    am: torch.Tensor       # (M, D) bipolar float32
    owners: torch.Tensor   # (M,) int32

    @property
    def device(self) -> torch.device:
        return self.am.device

    def encode_query(self, feats) -> torch.Tensor:
        return encoding.encode_query(self.enc_params, self.enc_cfg,
                                     on_device(feats, self.device))

    def predict(self, feats) -> torch.Tensor:
        """Plain product + first-wins argmax (no kernel)."""
        sims = self.encode_query(feats) @ self.am.T
        return self.owners[torch.argmax(sims, dim=-1)]

    def score(self, feats, labels, batch: int = 2048) -> float:
        feats = on_device(feats, self.device)
        labels = on_device(labels, self.device)
        n, correct = feats.shape[0], 0
        for b in range(0, n, batch):
            pred = self.predict(feats[b:b + batch])
            correct += int((pred == labels[b:b + batch]).sum())
        return correct / n

    @property
    def memory_bits(self) -> int:
        return self.enc_cfg.memory_bits + self.cfg.am_memory_bits()

    @property
    def memory_kb(self) -> float:
        return self.memory_bits / 8 / 1024


# -- shared helpers -----------------------------------------------------------

def _setup(gen: GenLike, cfg: BaselineConfig, feats, labels,
           draws: Optional[BaselineDraws], device):
    """(generator, encoder config, encoder params, feats, labels) on the
    fit's device: the GPU unless ``device`` says otherwise, or the
    generator's device when one is passed."""
    if isinstance(gen, torch.Generator):
        device = gen.device if device is None else resolve_device(device)
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, fit on {device}")
    else:
        device = resolve_device(device)
        gen = generator(gen, device)
    feats = on_device(feats, device)
    labels = on_device(labels, device).long()
    enc_cfg = _encoder_cfg(cfg, feats.shape[-1])
    if draws is not None and draws.enc_params is not None:
        enc_params = {k: on_device(np.asarray(v, np.float32), device)
                      for k, v in draws.enc_params.items()}
    else:
        enc_params = encoding.init_encoder(gen, enc_cfg)
    return gen, enc_cfg, enc_params, feats, labels


def _class_sums(h: torch.Tensor, labels: torch.Tensor,
                k: int) -> torch.Tensor:
    """(k, D) per-class sums of ``h`` as a one-hot product (deterministic
    on the GPU, unlike a float ``index_add_``)."""
    onehot = torch.nn.functional.one_hot(labels, k).to(h.dtype)
    return onehot.T @ h


def _binarize_centered(fp: torch.Tensor) -> torch.Tensor:
    # The mean as sum / n, the reference's ``jnp.mean``.
    return _sign(fp - fp.sum() / fp.numel())


def _quanthd_epoch(fp: torch.Tensor, binary: torch.Tensor, q: torch.Tensor,
                   labels: torch.Tensor, k: int, lr: float) -> torch.Tensor:
    """Eq.-(2) updates against a fixed binary AM snapshot (batched). The
    reference's scatter-adds of duplicate rows become one-hot products."""
    preds = torch.argmax(q @ binary.T, dim=-1)
    mis = (preds != labels).to(fp.dtype)
    coef = (lr * mis)[:, None] * q
    fp = fp + _class_sums(coef, labels, k)
    return fp - _class_sums(coef, preds, k)


def _owners(k: int, device, repeat: int = 1) -> torch.Tensor:
    return torch.arange(k, dtype=torch.int32,
                        device=device).repeat_interleave(repeat)


# -- the fitters --------------------------------------------------------------

def fit_basic(gen: GenLike, cfg: BaselineConfig, feats, labels, *,
              draws: Optional[BaselineDraws] = None,
              device=None) -> BaselineModel:
    gen, enc_cfg, enc_params, feats, labels = _setup(gen, cfg, feats,
                                                     labels, draws, device)
    h = encoding.encode(enc_params, enc_cfg, feats)
    am = _sign(_class_sums(h, labels, cfg.classes))
    return BaselineModel(cfg, enc_cfg, enc_params, am,
                         _owners(cfg.classes, am.device))


def fit_quanthd(gen: GenLike, cfg: BaselineConfig, feats, labels, *,
                draws: Optional[BaselineDraws] = None,
                device=None) -> BaselineModel:
    gen, enc_cfg, enc_params, feats, labels = _setup(gen, cfg, feats,
                                                     labels, draws, device)
    h = encoding.encode(enc_params, enc_cfg, feats)
    q = encoding.binarize_query(h)
    fp = _class_sums(h, labels, cfg.classes)
    binary = _binarize_centered(fp)
    for _ in range(cfg.epochs):
        fp = _quanthd_epoch(fp, binary, q, labels, cfg.classes, cfg.lr)
        binary = _binarize_centered(fp)
    return BaselineModel(cfg, enc_cfg, enc_params, binary,
                         _owners(cfg.classes, binary.device))


# -- LeHDC: BNN-style training with a straight-through estimator --------------

def _ste_sign(x: torch.Tensor) -> torch.Tensor:
    """sign(x) forward, identity gradient backward (not clipped, as the
    reference's code: its docstring says clipped)."""
    return x + (_sign(x) - x).detach()


def _lehdc_step(fp: torch.Tensor, vel: torch.Tensor, q: torch.Tensor,
                labels: torch.Tensor, lr: float, momentum: float):
    """One momentum-SGD step on mean NLL; weights clipped to [-1, 1]."""
    w = fp.detach().requires_grad_(True)
    logits = q @ _ste_sign(w).T / math.sqrt(w.shape[-1])
    logp = torch.log_softmax(logits, dim=-1)
    loss = -logp.gather(1, labels[:, None]).mean()
    (grad,) = torch.autograd.grad(loss, w)
    vel = momentum * vel - lr * grad
    return (fp + vel).clamp(-1.0, 1.0), vel, loss.detach()


def fit_lehdc(gen: GenLike, cfg: BaselineConfig, feats, labels, *,
              batch: int = 512, momentum: float = 0.9,
              draws: Optional[BaselineDraws] = None,
              device=None) -> BaselineModel:
    gen, enc_cfg, enc_params, feats, labels = _setup(gen, cfg, feats,
                                                     labels, draws, device)
    h = encoding.encode(enc_params, enc_cfg, feats)
    q = encoding.binarize_query(h)
    n = q.shape[0]
    if draws is not None and draws.lehdc_weights is not None:
        fp = on_device(np.asarray(draws.lehdc_weights, np.float32),
                       q.device)
    else:
        fp = 0.01 * torch.randn((cfg.classes, cfg.dim), generator=gen,
                                device=gen.device)
    vel = torch.zeros_like(fp)
    for _ in range(cfg.epochs):
        for b in range(0, n, batch):
            fp, vel, _ = _lehdc_step(fp, vel, q[b:b + batch],
                                     labels[b:b + batch], cfg.lr, momentum)
    return BaselineModel(cfg, enc_cfg, enc_params, _sign(fp),
                         _owners(cfg.classes, fp.device))


# -- SearcHD: N-vector stochastic quantization --------------------------------

def fit_searchd(gen: GenLike, cfg: BaselineConfig, feats, labels, *,
                draws: Optional[BaselineDraws] = None,
                device=None) -> BaselineModel:
    gen, enc_cfg, enc_params, feats, labels = _setup(gen, cfg, feats,
                                                     labels, draws, device)
    h = encoding.encode(enc_params, enc_cfg, feats)
    sums = _class_sums(h, labels, cfg.classes)  # (k, D) non-binary
    # Per-dimension firing probability from the standardized class
    # vector (population std, as numpy's); the 3x sharpening keeps the
    # Bernoulli noise from washing out the class signal at moderate D.
    std = sums.std(dim=-1, keepdim=True, correction=0) + 1e-8
    p_fire = torch.sigmoid(3.0 * sums / std)
    d = sums.shape[-1]
    if draws is not None and draws.searchd_uniforms is not None:
        u = on_device(np.asarray(draws.searchd_uniforms, np.float32),
                      sums.device)
    else:
        u = torch.rand((cfg.classes, cfg.n_models, d), generator=gen,
                       device=gen.device)
    am = torch.where(u < p_fire[:, None, :], 1.0, -1.0)
    am = am.reshape(cfg.classes * cfg.n_models, d)
    return BaselineModel(cfg, enc_cfg, enc_params, am,
                         _owners(cfg.classes, am.device, cfg.n_models))


FITTERS = {
    "basic": fit_basic,
    "quanthd": fit_quanthd,
    "lehdc": fit_lehdc,
    "searchd": fit_searchd,
}


def fit_baseline(gen: GenLike, cfg: BaselineConfig, feats, labels,
                 **kw) -> BaselineModel:
    return FITTERS[cfg.kind](gen, cfg, feats, labels, **kw)
