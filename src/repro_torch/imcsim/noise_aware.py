"""Noise-aware QAIL: train centroids that survive analog readout.

Port of ``repro.imcsim.noise_aware``. QAIL (§III-C) scores training
samples against the binary AM so training sees the deployed
representation; noise-aware QAIL scores them against a device-perturbed
view of it (the ``sim`` hook of ``qail.qail_epoch_scan``), so the
centroids learn margins that survive the analog readout. ``noise_mode``:

* ``"fixed"`` (default) — chip in the loop: every minibatch sees the one
  device instance ``deploy(target="imc", sim=sim)`` burns
  (``device.device_instance_key``), so QAIL compensates the very faults
  and conductance offsets it will serve on;
* ``"fresh"`` — a new perturbation per minibatch: expected accuracy over
  the device distribution.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.core.types import ImcSimConfig


def noise_aware_finetune(model, gen, feats, labels, sim: ImcSimConfig, *,
                         epochs: int = 10, noise_mode: str = "fixed",
                         **fit_kwargs) -> Tuple[object, Dict]:
    """Continue QAIL from the trained AM (``init_method="keep"``) with
    ``noise_sim=sim`` in the loop. Returns (model, history) like fit."""
    return model.fit(gen, feats, labels, init_method="keep", epochs=epochs,
                     noise_sim=sim, noise_mode=noise_mode, **fit_kwargs)


def multibit_finetune(model, gen, feats, labels, cell_bits: int, *,
                      sim: Optional[ImcSimConfig] = None, epochs: int = 10,
                      noise_mode: str = "fixed",
                      **fit_kwargs) -> Tuple[object, Dict]:
    """Quantization-aware fine-tune for the multi-bit deployment:
    ``fit(init_method="keep", cell_bits=cell_bits)`` selects every
    Eq.-(4)/(5) target against the ``cell_bits``-bit quantized view of
    the live float shadow, the representation ``deploy(target=
    "multibit", cell_bits=cell_bits)`` serves; a conductance-noise
    ``sim`` adds per-level-step noise to that view."""
    return model.fit(gen, feats, labels, init_method="keep", epochs=epochs,
                     cell_bits=cell_bits, noise_sim=sim,
                     noise_mode=noise_mode, **fit_kwargs)


def recovery_experiment(model, gen, feats, labels, test_feats, test_labels,
                        sim: ImcSimConfig, *, epochs: int = 10,
                        train_sim: Optional[ImcSimConfig] = None,
                        noise_mode: str = "fixed", **fit_kwargs) -> Dict:
    """How much deployment accuracy noise-aware QAIL recovers.

    1. score the model digitally and on the ``sim`` device;
    2. fine-tune it noise-aware against ``train_sim`` (default ``sim``:
       in the fixed mode, the very device instance of step 1);
    3. redeploy on the same instance and score again.

    Returns the three accuracies, the loss, the recovered part and
    ``recovered_frac`` = recovered / lost.
    """
    from repro_torch.imcsim.evaluate import imc_accuracy
    digital = model.score(test_feats, test_labels)
    noisy_before = imc_accuracy(model, test_feats, test_labels, sim)
    tuned, _ = noise_aware_finetune(model, gen, feats, labels,
                                    train_sim or sim, epochs=epochs,
                                    noise_mode=noise_mode, **fit_kwargs)
    noisy_after = imc_accuracy(tuned, test_feats, test_labels, sim)
    lost = digital - noisy_before
    recovered = noisy_after - noisy_before
    return {
        "digital_accuracy": digital,
        "noisy_accuracy_before": noisy_before,
        "noisy_accuracy_after": noisy_after,
        "lost": lost,
        "recovered": recovered,
        "recovered_frac": (recovered / lost) if lost > 1e-9 else 1.0,
        "epochs": epochs,
    }
