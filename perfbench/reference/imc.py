"""Reference of the simulated analog artifact (``target="imc"``).

The device instance is worked out again from the configuration's device
seed s, as the model defines it: a uniform field u and a normal field z
over the (C, D) cells and a normal field over the (D / rows, C / cols)
arrays, each from a generator on the device seeded by
``numpy.random.SeedSequence(key)`` with keys (s, 0, 0), (s, 0, 1) and
(s, 1). A cell with u < p0 reads -1, one with p0 <= u < p0 + p1 reads +1
(stuck-at faults), then every cell gains sigma * z (conductance
variation); each array's partial sum gains drift * its offset.

Search: the AM is cut into rows x cols arrays. An array's analog partial
sum is the dot of its rows of the query and the cells, summed one row
after the other from the first; the array's offset is added; the ADC
clips it to [-clip, clip] (clip = rows unless stated) and rounds it to
the nearest multiple of 2 * clip / 2**bits (ties to even); the row
arrays' codes are summed in order. The answer is the class of the best
column, the first on ties.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import reference as ref


def _field(key: tuple, shape: tuple, kind: str, device) -> torch.Tensor:
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=device)
    return torch.randn(shape, generator=gen, device=device)


def prepare(inputs, opts: dict, seed: int) -> dict:
    sim = opts["sim"]
    am = inputs.am
    c, d = am.shape
    dev = am.device
    s = int(sim["seed"])
    p0, p1 = sim["fault_p0"], sim["fault_p1"]
    if p0 > 0 or p1 > 0:
        u = _field((s, 0, 0), (c, d), "uniform", dev)
        am = torch.where(u < p0, am.new_tensor(-1.0), am)
        am = torch.where((u >= p0) & (u < p0 + p1), am.new_tensor(1.0), am)
    if sim["noise_sigma"] > 0:
        am = am + sim["noise_sigma"] * _field((s, 0, 1), (c, d), "normal",
                                              dev)
    rows, cols = sim["rows"], sim["cols"]
    gd, gc = -(-d // rows), -(-c // cols)
    offsets = None
    if sim["drift_sigma"] > 0:
        offsets = sim["drift_sigma"] * _field((s, 1), (gd, gc), "normal",
                                              dev)
    clip = float(sim.get("adc_clip") or rows)
    cells = torch.nn.functional.pad(am.T, (0, gc * cols - c,
                                           0, gd * rows - d))
    return {"projection": inputs.projection, "owners": inputs.owners,
            "cells": cells.reshape(gd, rows, gc * cols), "columns": c,
            "offsets": offsets, "cols": cols, "clip": clip,
            "step": torch.tensor(2.0 * clip / 2 ** sim["adc_bits"],
                                 dtype=torch.float32, device=dev)}


def answers(state: dict, feats: torch.Tensor, route: dict,
            lower: bool = False) -> tuple[tuple, dict]:
    if route["call"] != "predict_features":
        raise ValueError(f"imc: no reference for {route['call']!r}")
    q = ref.queries(feats, state["projection"], lower)
    cells = state["cells"]
    gd, rows, cp = cells.shape
    b = q.shape[0]
    qr = torch.nn.functional.pad(q, (0, gd * rows - q.shape[1])).reshape(
        b, gd, rows)
    part = torch.zeros((b, gd, cp), device=q.device)
    for r in range(rows):
        part = part + qr[:, :, r, None] * cells[None, :, r, :]
    if state["offsets"] is not None:
        part = part + torch.repeat_interleave(state["offsets"],
                                              state["cols"], dim=1)[None]
    clip, step = state["clip"], state["step"]
    codes = torch.round(torch.clamp(part, -clip, clip) / step) * step
    sims = torch.zeros((b, cp), device=q.device)
    for g in range(gd):
        sims = sims + codes[:, g]
    best = torch.argmax(sims[:, :state["columns"]], dim=-1)
    return (state["owners"][best],), {"columns": b * state["columns"]}
