"""Robustness evaluation: accuracy vs device fidelity, swept.

Port of ``repro.imcsim.evaluate``. Every point deploys the trained model
onto one simulated device instance (``deploy_imc``) and scores it
through the shared padded evaluator (``DeployedArtifact.score_queries``).
A sweep varies ONE fidelity axis of a base ``ImcSimConfig``; the rows
are plain JSON-able dicts for ``launch/robustness_report.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core.types import ImcSimConfig

# Default sweep axes: from "indistinguishable from digital" to "readout
# dominated by device error" at the flagship 128x128 point.
ADC_BITS = (16, 8, 6, 5, 4, 3, 2)
NOISE_SIGMAS = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0)
FAULT_RATES = (0.0, 0.01, 0.02, 0.05, 0.1, 0.2)


def _queries_of(model, feats, queries: Optional[torch.Tensor],
                ) -> torch.Tensor:
    """Encode once per sweep: every point shares the encoder, so each
    point pays only for its AM search."""
    return model.encode_query(feats) if queries is None else queries


def _score_queries(model, q: torch.Tensor, labels, sim: ImcSimConfig,
                   batch: int = 4096) -> float:
    from repro_torch.imcsim.deploy import deploy_imc
    return deploy_imc(model, sim).score_queries(q, labels, batch)


def imc_accuracy(model, feats, labels, sim: Optional[ImcSimConfig] = None,
                 batch: int = 4096,
                 queries: Optional[torch.Tensor] = None) -> float:
    """Accuracy of ``model`` deployed on one simulated device. Pass
    pre-encoded ``queries`` to reuse an encode of ``feats``."""
    return _score_queries(model, _queries_of(model, feats, queries),
                          labels, sim or ImcSimConfig(), batch)


def _sweep(model, feats, labels, base: ImcSimConfig, axis: str,
           values: Sequence, queries: Optional[torch.Tensor] = None,
           ) -> List[Dict]:
    q = _queries_of(model, feats, queries)
    return [{axis: v, "accuracy": _score_queries(
        model, q, labels, dataclasses.replace(base, **{axis: v}))}
        for v in values]


def sweep_adc_bits(model, feats, labels, bits: Sequence[int] = ADC_BITS,
                   base: Optional[ImcSimConfig] = None,
                   queries: Optional[torch.Tensor] = None) -> List[Dict]:
    """Accuracy vs ADC resolution (other knobs from ``base``)."""
    return _sweep(model, feats, labels, base or ImcSimConfig(),
                  "adc_bits", list(bits), queries)


def sweep_noise_sigma(model, feats, labels,
                      sigmas: Sequence[float] = NOISE_SIGMAS,
                      base: Optional[ImcSimConfig] = None,
                      queries: Optional[torch.Tensor] = None) -> List[Dict]:
    """Accuracy vs conductance-variation sigma."""
    return _sweep(model, feats, labels, base or ImcSimConfig(),
                  "noise_sigma", list(sigmas), queries)


def sweep_fault_rate(model, feats, labels,
                     rates: Sequence[float] = FAULT_RATES,
                     base: Optional[ImcSimConfig] = None,
                     queries: Optional[torch.Tensor] = None) -> List[Dict]:
    """Accuracy vs stuck-at fault rate (split evenly SA0 / SA1)."""
    base = base or ImcSimConfig()
    q = _queries_of(model, feats, queries)
    return [{"fault_rate": r, "accuracy": _score_queries(
        model, q, labels, dataclasses.replace(base, fault_p0=r / 2,
                                              fault_p1=r / 2))}
        for r in rates]


def robustness_report(model, feats, labels,
                      base: Optional[ImcSimConfig] = None,
                      adc_bits: Sequence[int] = ADC_BITS,
                      noise_sigmas: Sequence[float] = NOISE_SIGMAS,
                      fault_rates: Sequence[float] = FAULT_RATES) -> Dict:
    """The accuracy-vs-fidelity report of one trained model: the digital
    accuracy, the geometry and cycle count, and one sweep per axis (the
    other knobs at their ``base`` values)."""
    base = base or ImcSimConfig()
    q = model.encode_query(feats)  # one encode serves every point
    return {
        "geometry": f"{model.am_cfg.dim}x{model.am_cfg.columns}",
        "array": f"{base.arr.rows}x{base.arr.cols}",
        "cycles": model.imc_cost(base.arr).am.cycles,
        "digital_accuracy": model.score(feats, labels),
        "base_sim_accuracy": imc_accuracy(model, feats, labels, base,
                                          queries=q),
        "adc_sweep": sweep_adc_bits(model, feats, labels, adc_bits, base,
                                    queries=q),
        "noise_sweep": sweep_noise_sigma(model, feats, labels,
                                         noise_sigmas, base, queries=q),
        "fault_sweep": sweep_fault_rate(model, feats, labels, fault_rates,
                                        base, queries=q),
    }
