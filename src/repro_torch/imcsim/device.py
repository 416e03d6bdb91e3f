"""Device imperfection models: what the analog arrays do to stored bits.

Port of ``repro.imcsim.device``, with the random draws taken out of the
models. Three effects, each a perturbation of the resident bipolar AM
or of its readout:

* **Stuck-at faults** — a stuck-at-0 cell reads -1 and a stuck-at-1 cell
  +1 whatever was written: ``where(u < p0, -1, where(u < p0 + p1, +1,
  am))`` for a uniform field ``u``. Applied first.
* **Conductance variation** — ``am + sigma * z`` for a standard normal
  field ``z``.
* **Per-array readout drift** — one offset ``drift_sigma * z`` per
  physical array, added to that array's partial sum before the ADC;
  consumed by the ``am_search_imc`` kernel.

Draws. ``jax.random`` streams cannot be reproduced in torch, so the port
draws its own fields from ``torch.Generator`` streams, one per *key*: a
tuple of ints that mirrors the reference's key tree. For a sim with seed
s (the reference splits ``jax.random.key(s)`` into a cell key and a
drift key, and the cell key into a fault key and a noise key):

    (s, 0)      the cell key of the device instance (device_instance_key)
    (s, 0, 0)   its fault field u (uniform)     (s, 0, 1)  its noise z
    (s, 1)      the drift grid (normal)
    (s, e, b)   the fresh-mode draw of epoch e >= 1, batch b (the
                reference's fold_in(fold_in(key(s), e), b)), with its
                fault and noise fields at (s, e, b, 0) and (s, e, b, 1)

``draw`` seeds a generator on the target device from the key (through
``numpy.random.SeedSequence``), so equal keys give equal fields on one
device type; a CPU and a GPU draw of one key differ. Every function
that draws takes a ``sampler`` with ``draw``'s signature, so a caller
can hand in precomputed fields instead (the parity tests cross the
reference's fields that way). The device instance for a given seed is
therefore not the reference's: the fields differ, the models applied to
them are the same functions.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import generator
from repro_torch.core.types import ImcSimConfig

Key = Tuple[int, ...]
Sampler = Callable[[Key, tuple, str, torch.device], torch.Tensor]


def as_key(key: Union[int, Key]) -> Key:
    """An int seed or a key tuple, as a key tuple."""
    return (int(key),) if isinstance(key, int) else tuple(int(k) for k in key)


def draw(key: Key, shape: tuple, kind: str, device) -> torch.Tensor:
    """The default sampler: a float32 field of ``shape`` on ``device``,
    ``kind`` "uniform" ([0, 1)) or "normal" (standard), from a generator
    seeded by ``key``."""
    seed = int(np.random.SeedSequence(list(as_key(key))).generate_state(
        1, np.uint64)[0])
    g = generator(seed, device)
    if kind == "uniform":
        return torch.rand(shape, generator=g, device=device)
    if kind == "normal":
        return torch.randn(shape, generator=g, device=device)
    raise ValueError(f"bad field kind: {kind!r}")


def tile_grid(dim: int, columns: int, sim: ImcSimConfig) -> Tuple[int, int]:
    """(row-tiles, col-tiles) the (C, D) AM maps onto: the offset-grid
    shape, from ``core.imc.sim_grid`` (one tile decomposition shared by
    the device models, the kernel and the cost model)."""
    from repro_torch.core import imc
    return imc.sim_grid(dim, columns, sim.arr)


def conductance_noise(am: torch.Tensor, z: Optional[torch.Tensor],
                      sigma: float) -> torch.Tensor:
    """Gaussian conductance variation: ``am + sigma * z``."""
    if sigma == 0.0:
        return am
    return am + sigma * z


def stuck_at_faults(am: torch.Tensor, u: Optional[torch.Tensor], p0: float,
                    p1: float) -> torch.Tensor:
    """Disjoint stuck-at-0 (-> -1) / stuck-at-1 (-> +1) cells carved out
    of one uniform field ``u``."""
    if p0 == 0.0 and p1 == 0.0:
        return am
    minus, plus = am.new_tensor(-1.0), am.new_tensor(1.0)
    am = torch.where(u < p0, minus, am)
    return torch.where((u >= p0) & (u < p0 + p1), plus, am)


def tile_drift(z: torch.Tensor, sigma: float) -> torch.Tensor:
    """Per-array readout offsets ``sigma * z`` for a (gd, gc) normal grid
    ``z`` (the caller skips drift when sigma == 0)."""
    return sigma * z


def has_faults(sim: ImcSimConfig) -> bool:
    return sim.fault_p0 > 0.0 or sim.fault_p1 > 0.0


def draw_cells(key: Key, shape: tuple, sim: ImcSimConfig, device,
               sampler: Optional[Sampler] = None,
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The cell fields of one perturbation drawn under ``key``: (u, z),
    u the uniform fault field (None without faults), z the normal
    conductance field (None without noise)."""
    sampler = sampler or draw
    key = as_key(key)
    u = (sampler(key + (0,), tuple(shape), "uniform", device)
         if has_faults(sim) else None)
    z = (sampler(key + (1,), tuple(shape), "normal", device)
         if sim.noise_sigma > 0.0 else None)
    return u, z


def perturb_binary(binary_am: torch.Tensor, u: Optional[torch.Tensor],
                   z: Optional[torch.Tensor], sim: ImcSimConfig,
                   ) -> torch.Tensor:
    """Storage-path perturbations only (faults, then conductance noise):
    the AM view the noise-aware QAIL hook's sims MVM sees."""
    am = stuck_at_faults(binary_am, u, sim.fault_p0, sim.fault_p1)
    return conductance_noise(am, z, sim.noise_sigma)


def device_instance_key(sim: ImcSimConfig) -> Key:
    """The cell key of the deployed device instance: ``deploy_imc`` draws
    its faults and noise under it, and chip-in-the-loop training
    (``noise_mode="fixed"``) perturbs with exactly these draws."""
    return (int(sim.seed), 0)


def drift_key(sim: ImcSimConfig) -> Key:
    """The key of the deployed device instance's drift grid."""
    return (int(sim.seed), 1)


def draw_drift(sim: ImcSimConfig, dim: int, columns: int, device,
               sampler: Optional[Sampler] = None,
               ) -> Optional[torch.Tensor]:
    """The (gd, gc) readout offsets of the sim's device instance, or None
    when drift is off."""
    if sim.drift_sigma == 0.0:
        return None
    z = (sampler or draw)(drift_key(sim), tile_grid(dim, columns, sim),
                          "normal", device)
    return tile_drift(z, sim.drift_sigma)


def perturb_am(binary_am: torch.Tensor, sim: ImcSimConfig,
               sampler: Optional[Sampler] = None,
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The full device instance of a (C, D) binary AM under ``sim``:
    (the fault + noise perturbed AM, the (gd, gc) readout offsets or
    None). Deterministic in (sim, sampler)."""
    c, d = binary_am.shape
    u, z = draw_cells(device_instance_key(sim), (c, d), sim,
                      binary_am.device, sampler)
    am = perturb_binary(binary_am, u, z, sim)
    return am, draw_drift(sim, d, c, binary_am.device, sampler)
