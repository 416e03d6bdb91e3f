"""BENCHMARK.json against the benchmark's files and its contract's rules."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

from perfbench import generator

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"] for m in BENCH["end_to_end"]}


def _names(folder: str, suffix: str) -> list:
    return sorted(p.name[:-len(suffix)] for p in
                  (REPO / "perfbench" / folder).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


CONFIGS = _names("configs", ".json")
CELLS = _names("workloads", ".json")
READERS = _names("metrics", ".py")


def test_keys_and_run_length():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"},
                   {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"},
                  {"workloads"}),
}


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_exactly_the_contract_keys(kind):
    required, optional = KEYS[kind]
    assert 1 <= len(BENCH[kind])
    for e in BENCH[kind]:
        assert required <= set(e) <= required | optional, (kind, e["name"])


def test_free_text_is_one_short_line():
    texts = list(BENCH["command"])
    texts += [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and not re.search(r"[\n\r\t]", t), t
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("name", CONFIGS)
def test_configuration_files(name):
    """Every configuration file, listed or kept for a later cell; a listed
    one matches its entry."""
    path = REPO / "perfbench" / "configs" / f"{name}.json"
    data = json.loads(path.read_text())
    assert data["name"] == name
    listed = [c for c in BENCH["configs"] if c["name"] == name]
    for cfg in listed:
        assert REPO / cfg["file"] == path and cfg["reduced"] == []
    assert (REPO / "perfbench" / "inputs" / f"{data['inputs']}.py"
            ).is_file()
    # Features on the 2**-14 grid keep every float32 sum exact (< 2**10).
    assert data["data"]["feature_bits"] == 14 and data["features"] < 1024


@pytest.mark.parametrize("name", CELLS)
def test_cells_are_files_of_their_own(name):
    """Every cell file resolves to its traffic, loop, reference and step
    count; a listed cell matches its entry and reports its metrics."""
    spec = json.loads((REPO / "perfbench" / "workloads"
                       / f"{name}.json").read_text())
    assert spec["config"] in CONFIGS
    assert spec["chips"] == 1 and len(spec["why"]) <= 200
    mix = json.loads((REPO / "perfbench" / "traffic"
                      / f"{spec['traffic']}.json").read_text())
    assert (REPO / "perfbench" / "loops" / f"{mix['kind']}.py").is_file()
    target = mix["route"]["target"]
    for package, name_ in (("reference", target),
                           ("counts", f"step_{target}")):
        assert (REPO / "perfbench" / package / f"{name_}.py").is_file()
    for cell in [c for c in BENCH["workloads"] if c["name"] == name]:
        assert {k: cell[k] for k in spec} == spec
        assert cell["config"] in {c["name"] for c in BENCH["configs"]}
        reported = [m for m in BENCH["per_layer"]
                    if name in m.get("workloads", [name])]
        assert reported
        assert {"setup_s", "rows_per_s"} <= {
            m["name"] for m in BENCH["end_to_end"]
            if name in m.get("workloads", [name])}


def test_every_listed_entry_has_its_files():
    assert {c["name"] for c in BENCH["configs"]} <= set(CONFIGS)
    assert {c["name"] for c in BENCH["workloads"]} <= set(CELLS)
    assert {m["name"] for m in BENCH["per_layer"]} <= set(READERS)
    listed = {c["name"] for c in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", listed)) <= listed
    assert {c["config"] for c in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in E2E


@pytest.mark.parametrize("name", READERS)
def test_per_layer_metrics_have_readers(name):
    """Every reader; a ``<kernel>_roofline`` one has its kernel's count,
    and a listed one moves an end-to-end metric."""
    if name.endswith("_roofline"):
        kernel = name[:-len("_roofline")]
        assert (REPO / "perfbench" / "counts" / f"{kernel}.py").is_file()
    for m in [m for m in BENCH["per_layer"] if m["name"] == name]:
        assert m["moves"] in E2E and "\n" not in m["layer"]
        assert m["unit"] == "%" or not name.endswith("_roofline")


def test_ragged_requests_are_the_serving_clis():
    from repro_torch.launch.serve_memhd import synthetic_requests
    feats = np.arange(40 * 3, dtype=np.float32).reshape(40, 3)
    ours = generator.ragged_requests(feats, 9, 5, seed=4)
    theirs = synthetic_requests(feats, 9, 5, seed=4)
    assert len(ours) == len(theirs)
    assert all(np.array_equal(a, r.feats) for a, r in zip(ours, theirs))


@pytest.mark.parametrize("path", sorted((REPO / "perfbench" / "workloads")
                                        .glob("*.json")), ids=lambda p: p.stem)
def test_every_cell_file_resolves(path):
    """Cell files kept for later cells as well as those of BENCHMARK.json:
    each names files that exist, down to its loop and its reference."""
    from perfbench import harness
    cell = harness.resolve(path.stem)
    assert cell.spec["chips"] == 1 and len(cell.spec["why"]) <= 200
    for package, name in (("loops", cell.traffic["kind"]),
                          ("reference", cell.route["target"]),
                          ("counts", f"step_{cell.route['target']}")):
        assert (REPO / "perfbench" / package / f"{name}.py").is_file()
