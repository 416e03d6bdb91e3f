"""Device-fidelity IMC simulation (port of ``repro.imcsim``).

``core.imc`` accounts for the IMC deployment in closed form; this
package executes it:

* ``device`` — device imperfections as perturbations of the resident
  bipolar AM (stuck-at faults, conductance variation) and a per-array
  readout offset grid (drift). The random fields are drawn apart from
  applying them: drawn from ``torch.Generator`` streams keyed by the
  sim's seed, or handed in by the caller (the tests cross the
  reference's ``jax.random`` fields this way).
* ``kernels/am_search_imc`` — the tiled analog search: per-array
  partial sums, ADC, digital accumulation, argmax.
* ``deploy`` — ``ImcDeployedMemhd``, the ``"imc"`` backend of
  ``MemhdModel.deploy``.
* ``evaluate`` — accuracy vs ADC bits / noise sigma / fault rate.
* ``noise_aware`` — noise-aware QAIL fine-tuning, the recovery
  experiment and the multi-bit QAT fine-tune.
"""
from repro_torch.core.types import ImcSimConfig  # noqa: F401
from repro_torch.imcsim.deploy import ImcDeployedMemhd, deploy_imc  # noqa: F401
from repro_torch.imcsim.device import (  # noqa: F401
    conductance_noise, perturb_am, perturb_binary, stuck_at_faults,
    tile_drift, tile_grid,
)
from repro_torch.imcsim.evaluate import (  # noqa: F401
    imc_accuracy, robustness_report, sweep_adc_bits, sweep_fault_rate,
    sweep_noise_sigma,
)
from repro_torch.imcsim.noise_aware import (  # noqa: F401
    multibit_finetune, noise_aware_finetune, recovery_experiment,
)
