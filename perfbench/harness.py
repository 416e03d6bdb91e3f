"""One run of one cell: set-up, the timed window, the check, the metrics.

``run(name, seed, seconds, trace)`` resolves the cell by name
(``workloads/<name>.json``, its ``configs/`` and ``traffic/`` files),
makes the inputs from the seed on the device, deploys the
configuration's program (``programs/<name>.py``) from them, warms the
batch shape up, runs the window with the loop of the mix's kind
(``loops/<kind>.py``) and then checks every pool row the window served
against the plain reference (``reference/<target>.py``), which also
decides when a row's answers agree, after the program's state is freed.
It returns the result line's fields; ``run.py`` prints them.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from perfbench import generator, reference, trace

ROOT = Path(__file__).resolve().parent
TRACE_SECONDS = 3.0   # a --trace 1 run profiles the window's last seconds
WARMUP_CALLS = 3      # calls of the batch shape before the window


def load_json(root: Path, kind: str, name: str) -> dict:
    with open(Path(root) / kind / f"{name}.json") as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    spec: dict        # workloads/<name>.json
    config: dict      # configs/<spec["config"]>.json
    traffic: dict     # traffic/<spec["traffic"]>.json

    @property
    def route(self) -> dict:
        return self.traffic["route"]

    @property
    def program(self) -> str:
        """The program family that serves the cell (``programs/``)."""
        return self.config.get("program", "memhd")

    @property
    def deploy_opts(self) -> dict:
        """The configuration's options for the route's deploy target."""
        return dict(self.config.get("deploy", {}).get(self.route["target"],
                                                       {}))


def resolve(name: str, root: Path = ROOT) -> Cell:
    spec = load_json(root, "workloads", name)
    return Cell(spec, load_json(root, "configs", spec["config"]),
                load_json(root, "traffic", spec["traffic"]))


def benchmark_metrics(root: Path, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries of the checkout's
    ``BENCHMARK.json`` that this cell reports."""
    with open(Path(root).parent / "BENCHMARK.json") as fh:
        entries = json.load(fh)[kind]
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Answers:
    """The first answer the window returned for each pool row, and which
    rows ever came back different from it by ``differ`` (the reference's
    ``rows_differ``). A batch equal to its slot's first answers byte for
    byte costs one comparison of bytes."""

    def __init__(self, n_slots: int, differ):
        self.first = [None] * n_slots
        self.first_bytes = [None] * n_slots
        self.changed = [None] * n_slots
        self.differ = differ

    def add(self, slot: int, host) -> None:
        outs = [h.numpy() for h in host]
        if self.first[slot] is None:
            self.first[slot] = [o.copy() for o in outs]
            self.first_bytes[slot] = [o.tobytes() for o in outs]
            self.changed[slot] = np.zeros(outs[0].shape[0], bool)
            return
        for o, f, fb in zip(outs, self.first[slot], self.first_bytes[slot]):
            if o.tobytes() != fb:
                self.changed[slot] |= self.differ(o, f)


def _rows_differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rows of one answer that are not equal element for element."""
    d = a != b
    return d.reshape(d.shape[0], -1).any(axis=1)


def judge(ref):
    """How the reference module ``ref`` judges one answer, ``(got, want)
    -> (rows,) bool``, true where a row differs: its own ``rows_differ``
    or, where it defines none, exact equality.

    A reference that defines ``rows_differ`` states its tolerance beside
    the reason for it, and its control (the reference one precision
    lower, ``lower=True``) must still fail that tolerance.
    """
    return getattr(ref, "rows_differ", _rows_differ)


@dataclasses.dataclass
class Setup:
    inputs: object        # what inputs/<name>.py built
    pool: torch.Tensor    # (pool_rows, ...) input rows
    call: object          # a batch of input rows -> tuple of answers
    like: tuple           # one call's answers (shapes, types)
    seconds: float        # set-up time, process start to here
    parts: dict           # seconds of each part of the set-up


def make_inputs(cell: Cell, seed: int, device: torch.device,
                root: Path = ROOT) -> tuple:
    """(the configuration's inputs, the pool of input rows), from the
    seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cfg = cell.config
    with reference.precision(False):
        inputs = trace.load_module(root, "inputs", cfg["inputs"]).build(
            cfg, gen)
        return inputs, inputs.sample(cell.traffic["pool_rows"])


def deploy(cell: Cell, inputs, seed: int, root: Path = ROOT):
    """The configuration's program, deployed from ``inputs`` for the
    cell's route by ``programs/<cell.program>.py``: a callable from a
    batch of pool rows to the tuple of answers."""
    program = trace.load_module(root, "programs", cell.program)
    if program is None:
        raise ValueError(f"no program {cell.program!r}")
    return program.deploy(cell, inputs, seed, root)


def control_call(cell: Cell, inputs, seed: int, root: Path = ROOT):
    """The control, a serving call to stand in the program's place: the
    plain reference one precision lower (``lower=True``) than the one the
    configuration states; TF32 products for a float32 configuration."""
    ref = trace.load_module(root, "reference", cell.route["target"])
    state = ref.prepare(inputs, cell.deploy_opts, seed)

    def call(x):
        return ref.answers(state, x, cell.route, lower=True)[0]

    return call


def setup(cell: Cell, seed: int, device: torch.device, t_start: float,
          root: Path = ROOT, make_call=deploy) -> Setup:
    """Inputs from the seed, the program's artifact (or what
    ``make_call`` puts in its place), the warm-up."""
    import repro_torch  # noqa: F401  (float32 products, TF32 off)

    parts = {"imports": time.perf_counter() - t_start}

    def part(name):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        parts[name] = time.perf_counter() - t_start - sum(parts.values())

    if device.type == "cuda":
        from repro_torch.kernels import _build
        torch.cuda.init()
        _build.lib()  # the kernel library (nvcc on a checkout's first run)
    part("cuda_and_library")
    inputs, pool = make_inputs(cell, seed, device, root)
    part("inputs")
    call = make_call(cell, inputs, seed, root)
    part("deploy")
    rows = cell.traffic["batch_rows"]
    for _ in range(WARMUP_CALLS):
        like = tuple(o.cpu() for o in call(pool[:rows]))
    part("warm_up")
    # What set-up made lives on: keep the collector from walking it.
    gc.collect()
    gc.freeze()
    return Setup(inputs, pool, call, like,
                 time.perf_counter() - t_start, parts)


def check(cell: Cell, s: Setup, answers: Answers, seed: int,
          root: Path = ROOT) -> tuple[int, int, list]:
    """(rows wrong, rows checked, the reference's work a pool slot): a
    pool row is wrong when any answer the window returned for it differs
    from the reference's, as the reference's ``rows_differ`` judges."""
    ref = trace.load_module(root, "reference", cell.route["target"])
    differ = judge(ref)
    state = ref.prepare(s.inputs, cell.deploy_opts, seed)
    rows = cell.traffic["batch_rows"]
    wrong = checked = 0
    works = [None] * len(answers.first)
    for slot, first in enumerate(answers.first):
        if first is None:
            continue
        want, works[slot] = ref.answers(
            state, s.pool[slot * rows:(slot + 1) * rows], cell.route)
        bad = answers.changed[slot].copy()
        for got, w in zip(first, want):
            bad |= differ(got, w.cpu().numpy())
        wrong += int(bad.sum())
        checked += rows
    return wrong, checked, works


def _plain_dispatches(ops) -> int:
    """Kernel dispatches the process has sent to a tier other than the
    CUDA kernels (``kernel_dispatch_total``)."""
    return sum(n for tiers in ops.dispatch_breakdown().values()
               for tier, n in tiers.items() if tier != "cuda")


def run(name: str, seed: int, seconds: float, traced: bool, *,
        t_start: Optional[float] = None, root: Path = ROOT,
        device: str = "cuda", strict: bool = True,
        make_call=deploy) -> dict:
    """One run; ``strict`` (the card) stops on a dispatch of this run
    served by the plain versions or a kernel build inside the window.
    ``make_call``
    builds what serves the window: the program's artifact, or
    ``control_call``."""
    from repro_torch.kernels import ops
    from repro_torch.obs import torchmon

    t_start = time.perf_counter() if t_start is None else t_start
    plain_before = _plain_dispatches(ops)
    seed = int(seed) % 2 ** 64
    dev = torch.device(device)
    cell = resolve(name, root)
    s = setup(cell, seed, dev, t_start, root, make_call)
    mix = cell.traffic
    n_slots = mix["pool_rows"] // mix["batch_rows"]
    answers = Answers(n_slots, judge(trace.load_module(
        root, "reference", cell.route["target"])))
    builds = torchmon.rebuilds()
    win = generator.loop(root, mix["kind"]).run(
        s.call, s.pool, mix, seconds, answers.add, s.like,
        trace_seconds=min(TRACE_SECONDS, seconds) if traced else 0.0)
    gc.unfreeze()
    rebuilt = torchmon.rebuilds() - builds
    plain = _plain_dispatches(ops) - plain_before
    if strict and plain:
        raise RuntimeError(f"{plain} kernel dispatches went to the plain "
                           f"versions: {ops.dispatch_breakdown()}")
    if strict and rebuilt:
        raise RuntimeError(f"{rebuilt} kernel builds or graph captures "
                           f"inside the window")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    s.call = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    wrong, checked, works = check(cell, s, answers, seed, root)
    t_check = time.perf_counter() - t_check

    out = {"correct": checked > 0 and wrong == 0,
           "attempted": win.attempted,
           "failed": win.attempted - win.answered}
    if traced:
        ctx = trace.Context(
            root=root, config=cell.config, route=cell.route,
            batch_rows=mix["batch_rows"],
            peaks=json.loads((root / "peaks.json").read_text()),
            profile=win.profile, calls=len(win.traced_slots),
            rows=len(win.traced_slots) * mix["batch_rows"],
            works=[works[slot] for slot in win.traced_slots],
            dispatch_s=win.dispatch_s, dispatch_calls=win.dispatch_calls,
            readings=win.readings)
        metrics = {}
        for m in benchmark_metrics(root, name, "per_layer"):
            value = trace.load_module(root, "metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        taken = {**win.readings, "setup_s": s.seconds}
        metrics = {m["name"]: {"value": taken[m["name"]], "unit": m["unit"]}
                   for m in benchmark_metrics(root, name, "end_to_end")}
    out["metrics"] = metrics
    out["device"] = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                     "kind": (torch.cuda.get_device_name(dev)
                              if dev.type == "cuda" else "cpu"),
                     "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        out["device"]["busy_s"] = win.profile.busy_s
        out["device"]["window_s"] = win.profile.window_s
        out["breakdown"] = {"device_ops": win.profile.device_ops(),
                            "idle_gaps": win.profile.idle_gaps()}
    out["info"] = {"setup": s.parts, "checked_rows": checked,
                   "check_s": t_check,
                   "traced_calls": len(win.traced_slots),
                   "window_s": win.seconds, "batches": win.batches}
    out["checks"] = {
        "rows_wrong": {"value": wrong, "limit": 0},
        "plain_dispatches": {"value": plain, "limit": 0},
        "window_builds": {"value": rebuilt, "limit": 0}}
    return out
