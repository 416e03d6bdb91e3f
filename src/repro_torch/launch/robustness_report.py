"""Accuracy-vs-fidelity JSON report for a deployed MEMHD model.

Port of ``repro.launch.robustness_report``. Trains (or smoke-trains) a
MEMHD model, deploys it onto simulated analog arrays across the fidelity
grid (ADC bits, conductance noise sigma, stuck-at fault rate), runs the
noise-aware QAIL recovery experiment at the headline noisy point, and
prints everything as one JSON document. Every search of the sweeps goes
through ``am_search_imc``, and the fit and the noise-aware fine-tune
through ``qail_update``, on the GPU.

Usage (on the GPU; ``--device cpu`` for the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.robustness_report --smoke
  PYTHONPATH=src python -m repro_torch.launch.robustness_report \
      --noise-sigma 0.5 --adc-bits 16,8,6,4 --finetune-epochs 10
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from typing import Dict, Optional, Sequence

from repro_torch import obs

log = logging.getLogger("robustness_report")


def _floats(s: str):
    return [float(x) for x in s.split(",") if x]


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny training budget (CI-sized)")
    ap.add_argument("--dataset", default="mnist")
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--columns", type=int, default=128)
    ap.add_argument("--adc-bits", type=_ints, default=[16, 8, 6, 4, 3])
    ap.add_argument("--noise-sigmas", type=_floats,
                    default=[0.0, 0.25, 0.5, 1.0])
    ap.add_argument("--fault-rates", type=_floats,
                    default=[0.0, 0.02, 0.05, 0.1])
    ap.add_argument("--noise-sigma", type=float, default=0.5,
                    help="headline noisy point for the recovery run")
    ap.add_argument("--device-seed", type=int, default=7)
    ap.add_argument("--finetune-epochs", type=int, default=10)
    ap.add_argument("--out", default=None,
                    help="write the JSON here instead of stdout")
    ap.add_argument("--log-json", action="store_true",
                    help="structured one-JSON-per-line logging")
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    obs.setup_logging(json_mode=args.log_json)

    from repro_torch import resolve_device
    from repro_torch.core import (
        EncoderConfig, ImcSimConfig, MemhdConfig, MemhdModel,
    )
    from repro_torch.data import load_dataset
    from repro_torch.imcsim import recovery_experiment, robustness_report

    device = resolve_device(args.device)
    per_class = 120 if args.smoke else 400
    epochs = 4 if args.smoke else 20
    ds = load_dataset(args.dataset, train_per_class=per_class,
                      test_per_class=40, device=device)
    enc = EncoderConfig(kind="projection", features=ds.features,
                        dim=args.dim)
    amc = MemhdConfig(dim=args.dim, columns=args.columns,
                      classes=ds.classes, epochs=epochs,
                      kmeans_iters=5 if args.smoke else 25)
    t0 = time.time()
    model = MemhdModel.create(0, enc, amc, device=device)
    model, _ = model.fit(1, ds.train_x, ds.train_y, use_kernel=True)
    log.info("trained %sx%s model in %.1fs", args.dim, args.columns,
             time.time() - t0)

    base = ImcSimConfig(seed=args.device_seed)
    report = robustness_report(
        model, ds.test_x, ds.test_y, base=base, adc_bits=args.adc_bits,
        noise_sigmas=args.noise_sigmas, fault_rates=args.fault_rates)

    noisy = dataclasses.replace(base, noise_sigma=args.noise_sigma)
    report["recovery"] = dict(
        recovery_experiment(
            model, 2, ds.train_x, ds.train_y, ds.test_x, ds.test_y, noisy,
            epochs=args.finetune_epochs, use_kernel=True),
        noise_sigma=args.noise_sigma, device_seed=args.device_seed)
    report["dataset"] = ds.name
    report["wall_s"] = round(time.time() - t0, 2)

    text = json.dumps(report, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        log.info("wrote %s", args.out)
    else:
        print(text)
    return report


if __name__ == "__main__":
    main()
