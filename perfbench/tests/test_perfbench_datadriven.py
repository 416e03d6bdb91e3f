"""The harness is data: a configuration, a traffic mix, the loop of a new
kind of traffic with an end-to-end reading of its own, a cell, a
per-layer metric, and a program family with its inputs and its reference
added as files are found by name and run, with no file that was there
edited."""
import functools
import hashlib
import json

import pytest

from perfbench import control, harness, trace
from perfbench.tests.conftest import make_tiny


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


# A new kind of traffic: the closed loop, found by name, with one more
# end-to-end reading.
LOOP = """
from pathlib import Path
from perfbench import trace


def run(*args, **kwargs):
    win = trace.load_module(Path(__file__).parent.parent, "loops",
                            "closed_bulk").run(*args, **kwargs)
    win.readings["batches_per_s"] = win.batches / win.seconds
    return win
"""


def test_added_files_are_found_and_run(tmp_path, counted_clock):
    root = make_tiny(tmp_path)
    before = digests(root)
    cfg = json.loads((root / "configs" / "memhd-mnist-1024x1024.json")
                     .read_text())
    cfg.update(name="memhd-mnist-64x64", dim=64, columns=64)
    (root / "configs" / "memhd-mnist-64x64.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "traffic" / "bulk4k-top1-packed.json")
                     .read_text())
    mix.update(kind="closed_bulk_counted", pool_rows=256, batch_rows=64,
               in_flight=2)
    (root / "traffic" / "bulk64-top1-packed.json").write_text(
        json.dumps(mix))
    cell = {"config": "memhd-mnist-64x64", "traffic": "bulk64-top1-packed",
            "chips": 1, "why": "a small added cell"}
    (root / "workloads" / "mnist64-small.json").write_text(json.dumps(cell))
    (root / "loops" / "closed_bulk_counted.py").write_text(LOOP)
    (root / "metrics" / "rows_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.rows)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "memhd-mnist-64x64",
                             "source": "test", "reduced": [],
                             "why": "a small added configuration",
                             "file": "perfbench/configs/memhd-mnist-64x64.json"})
    bench["workloads"].append({"name": "mnist64-small", **cell})
    bench["per_layer"].append({
        "name": "rows_traced", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "test", "moves": "rows_per_s",
        "workloads": ["mnist64-small"]})
    bench["end_to_end"].append({
        "name": "batches_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["mnist64-small"]})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m and m["name"] in ("device_idle_share",
                                              "step_mfu",
                                              "window_batch_p95_ms"):
            m["workloads"].append("mnist64-small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    counted_clock(root)
    found = harness.resolve("mnist64-small", root)
    assert found.config["dim"] == 64 and found.traffic["batch_rows"] == 64
    assert callable(trace.load_module(root, "metrics", "rows_traced").read)
    out = harness.run("mnist64-small", 3, 0.3, True, root=root,
                      device="cpu", strict=False)
    assert out["correct"]
    assert out["metrics"]["rows_traced"]["value"] > 0
    assert {"device_idle_share", "step_mfu",
            "window_batch_p95_ms"} <= set(out["metrics"])
    assert out["metrics"]["window_batch_p95_ms"]["value"] > 0
    out = harness.run("mnist64-small", 3, 0.3, False, root=root,
                      device="cpu", strict=False)
    assert out["correct"]
    assert set(out["metrics"]) == {"rows_per_s", "setup_s",
                                   "batches_per_s"}
    assert out["metrics"]["batches_per_s"]["value"] > 0
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())


# A second program family, added as new files alone: int32 token rows in,
# float next-token logits out, judged by its reference's tolerance.
TOKEN_INPUTS = """
import types
import torch


def build(cfg, gen):
    dev = gen.device
    emb = torch.randn((cfg["vocab"], cfg["d_model"]), generator=gen,
                      device=dev)
    head = torch.randn((cfg["d_model"], cfg["vocab"]), generator=gen,
                       device=dev)

    def sample(n):
        return torch.randint(0, cfg["vocab"], (n, cfg["seq_len"]),
                             generator=gen, device=dev, dtype=torch.int32)

    return types.SimpleNamespace(emb=emb, head=head, sample=sample)
"""

# The program: mean-pooled embeddings through the head, its answers moved
# by ``shift`` of each row's largest logit from call ``shift_after`` on.
TOKEN_PROGRAM = """
def deploy(cell, inputs, seed, root):
    cfg, calls = cell.config, [0]

    def call(tokens):
        logits = inputs.emb[tokens.long()].mean(dim=1) @ inputs.head
        calls[0] += 1
        if calls[0] > cfg["shift_after"]:
            logits = logits + cfg["shift"] * logits.abs().amax(
                dim=1, keepdim=True)
        return (logits,)

    return call
"""

# The reference: the same logits by token counts, in float32; the control
# (``lower``) rounds the operands to TF32.
TOKEN_REFERENCE = """
import numpy as np
import torch

from perfbench import reference as ref

# A row agrees when no logit is off by more than 2**-13 of the row's
# largest: float32 sums in another order differ by a few ulps (2**-24) of
# it, and TF32 operands (the control, 11 significant bits) by about 2**-11.
TOL = 2.0 ** -13


def prepare(inputs, opts, seed):
    return {"emb": inputs.emb, "head": inputs.head}


def answers(state, tokens, route, lower=False):
    emb = state["emb"]
    counts = torch.nn.functional.one_hot(tokens.long(), emb.shape[0]).sum(1)
    pooled = ref.matmul(counts.float(), emb, lower) / tokens.shape[1]
    return (ref.matmul(pooled, state["head"], lower),), {}


def rows_differ(got, want):
    scale = np.abs(want).max(axis=1)
    return np.abs(got - want).max(axis=1) > TOL * scale
"""

# (shift, whether it starts on the slots' later visits, control, correct)
TOKEN_CASES = {
    "sound": (0.0, False, False, True),
    "past_the_tolerance": (2.0 ** -8, False, False, False),
    "later_visit_within": (2.0 ** -17, True, False, True),
    "later_visit_past": (2.0 ** -8, True, False, False),
    "the_control": (0.0, False, True, False),
}


@pytest.mark.parametrize("case", sorted(TOKEN_CASES))
def test_another_program_family_by_new_files(tmp_path, counted_clock,
                                             case):
    """Token rows served by a program of its own, judged by its
    reference's ``rows_differ``: within the tolerance correct, on a first
    visit or a later one; past it, or the control, not correct."""
    shift, later, use_control, want = TOKEN_CASES[case]
    root = make_tiny(tmp_path, {})
    before = digests(root)
    mix = {"kind": "closed_bulk", "pool_rows": 64, "batch_rows": 16,
           "in_flight": 2, "route": {"target": "tokens", "call": "logits"}}
    n_slots = mix["pool_rows"] // mix["batch_rows"]
    cfg = {"name": "tokens-tiny", "program": "tokens", "inputs": "tokens",
           "vocab": 96, "d_model": 64, "seq_len": 12, "shift": shift,
           "shift_after": harness.WARMUP_CALLS + n_slots if later else 0}
    cell = {"config": "tokens-tiny", "traffic": "tokens-bulk", "chips": 1,
            "why": "token rows of one length"}
    for folder, name, text in (
            ("configs", "tokens-tiny.json", json.dumps(cfg)),
            ("traffic", "tokens-bulk.json", json.dumps(mix)),
            ("workloads", "tokens-bulk.json", json.dumps(cell)),
            ("inputs", "tokens.py", TOKEN_INPUTS),
            ("programs", "tokens.py", TOKEN_PROGRAM),
            ("reference", "tokens.py", TOKEN_REFERENCE)):
        assert not (root / folder / name).exists()
        (root / folder / name).write_text(text)

    counted_clock(root)
    run = control.run if use_control else functools.partial(harness.run,
                                                            traced=False)
    out = run("tokens-bulk", 2 ** 33 + 11, 0.05, root=root, device="cpu",
              strict=False)
    assert out["info"]["batches"] > n_slots
    assert out["info"]["checked_rows"] == mix["pool_rows"]
    assert out["correct"] is want, out["checks"]
    assert set(out["metrics"]) == {"rows_per_s", "setup_s"}
    after = digests(root)
    assert all(after[p] == d for p, d in before.items())
