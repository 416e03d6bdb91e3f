"""The harness is data: a configuration, a traffic mix, the loop of a new
kind of traffic with an end-to-end reading of its own, a cell and a
per-layer metric added as files are found by name and run, with no file
that was there edited."""
import hashlib
import json

from perfbench import harness, trace
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
