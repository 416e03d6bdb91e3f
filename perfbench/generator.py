"""Traffic: the general generator that every mix under ``traffic/`` feeds.

A mix file names its ``kind``, and the loop of that kind is the module
``loops/<kind>.py``, found by name: its ``run(call, pool, mix, seconds,
on_back, like, *, trace_seconds)`` serves the mix's batches of the
device-resident ``pool`` of input rows through ``call`` for ``seconds``,
hands each batch's answers on the host to ``on_back(slot, outputs)``, and
returns a ``Window``: what it measured on the host's clock, the
end-to-end readings among it. A new kind of traffic is a new file there.

A row is one input of the cell's call: for MEMHD one feature row, for a
language model one sequence at the lengths its traffic file states.

``ragged_requests`` is the ragged request stream of the program's serving
CLI (``launch/serve_memhd.synthetic_requests``), kept here for a mix of
host requests that no cell uses yet.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

from perfbench import trace


@dataclasses.dataclass
class Window:
    """What a loop measured."""

    seconds: float            # the window's length on the host's clock
    batches: int              # calls dispatched
    attempted: int            # rows dispatched
    answered: int             # rows whose answers reached the host
    readings: dict            # end-to-end metric name -> value
    dispatch_s: float         # host time inside the call, untraced calls
    dispatch_calls: int
    traced_slots: List[int]   # pool slot of each traced call, in order
    profile: Optional[trace.Profile]


class HostEvent:
    """Stands in for a CUDA event on the CPU, where calls are synchronous."""

    def record(self):
        pass

    def synchronize(self):
        pass


def loop(root: Path, kind: str):
    """The module ``loops/<kind>.py`` of the benchmark's folder."""
    mod = trace.load_module(root, "loops", kind)
    if mod is None:
        raise ValueError(f"no loop for traffic of kind {kind!r}")
    return mod


def ragged_requests(feats: np.ndarray, n_requests: int, max_size: int,
                    seed: int = 0) -> List[np.ndarray]:
    """Ragged requests of 1..``max_size`` rows drawn from a feature pool:
    the row blocks of ``synthetic_requests``, draw for draw."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_requests):
        n = int(rng.integers(1, max_size + 1))
        reqs.append(feats[rng.integers(0, feats.shape[0], size=n)])
    return reqs
