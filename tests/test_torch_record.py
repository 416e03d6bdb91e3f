"""The port's serving record (``repro_torch.obs.record``) against the JAX
package's ``benchmarks.record``, on the CPU.

The same report through both ``from_report``s gives the same metrics and
the same meta (apart from ``meta["obs"]``, each package's own counters);
the top-level keys differ only by the device pair (``torch_version`` and
``device`` in place of ``jax_backend`` and ``jax_version``). On a CUDA
device the record names the card and its ``nvidia-smi`` power limit, and
a failing ``nvidia-smi`` raises.
"""
import json
import subprocess

import pytest

torch = pytest.importorskip("torch")

from benchmarks import record as jrecord  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.obs import record, torchmon  # noqa: E402

REPORTS = {
    "serve_memhd": {
        "workload": "memhd_serve", "backend": "packed", "devices": 1,
        "requests": 64, "rows": 1033, "wall_s": 0.0831, "qps": 770.2,
        "rows_per_s": 12431.5, "pad_overhead": 0.0213, "fused": True,
        "lat_ms_min": 0.41, "lat_ms_p50": 1.0625, "lat_ms_p99": 3.7,
        "service_ms_p50": 0.52, "service_ms_total": 12.25,
        "queue_ms_p99": 2.0, "resident_am_bytes": 2048,
        "metrics": {"compiles_total": 3, "recompiles_steady_state": 0,
                    "dispatch_tiers": {"am_search_packed": {"cuda": 9},
                                       "pack_rows": {"cuda": 9}}},
        "cycles": None, "topk": 0,
    },
    "serve_online": {
        "workload": "memhd_online_serve", "device": "cpu", "classes": 10,
        "geometry": "128x36", "scenario": {"drift": 0.35,
                                           "append_class": True,
                                           "deadline_ms": None},
        "requests": 45, "qps": 311.0, "lat_ms_p50": 2.5, "lat_ms_p95": 7,
        "service_ms_p50": 1.25, "deadline_miss_rate": 0.0,
        "model_generation": 2, "recompiles_steady_state": 0,
        "generations": [{"generation": 1, "shape_stable": True},
                        {"generation": 2, "shape_stable": False}],
        "phases": {"A": {"accuracy": 0.95, "lat_ms_p50": 2.0}},
        "shape_stable": False,
    },
}
CPU_DEVICE = {"platform": "cpu", "name": "cpu", "power_limit_w": None,
              "count": 1}


@pytest.mark.parametrize("bench", sorted(REPORTS))
def test_from_report_matches_the_reference(tmp_path, bench):
    report = REPORTS[bench]
    ref_path = jrecord.from_report(bench, report,
                                   out_dir=str(tmp_path / "ref"))
    port_path = record.from_report(bench, report,
                                   out_dir=str(tmp_path / "port"))
    assert port_path == str(tmp_path / "port" / f"BENCH_{bench}.json")
    assert ref_path.endswith(f"BENCH_{bench}.json")
    want = json.loads(open(ref_path).read())
    got = json.loads(open(port_path).read())
    assert got["metrics"] == want["metrics"]
    assert ({k: v for k, v in got["meta"].items() if k != "obs"}
            == {k: v for k, v in want["meta"].items() if k != "obs"})
    assert set(got["meta"]["obs"]) == set(want["meta"]["obs"]) == {
        "compiles_total", "dispatch_tiers"}
    assert set(want) - set(got) == {"jax_backend", "jax_version"}
    assert set(got) - set(want) == {"torch_version", "device"}
    assert set(got) == record.TOP_LEVEL_KEYS
    assert got["schema_version"] == want["schema_version"] == 1
    assert got["bench"] == bench
    assert got["device"] == CPU_DEVICE
    assert got["torch_version"] == torch.__version__
    for m in got["metrics"].values():
        assert record.METRIC_REQUIRED_KEYS <= set(m)


def test_from_report_splits_metrics_and_meta(tmp_path):
    path = record.from_report("demo", REPORTS["serve_memhd"], str(tmp_path))
    got = json.loads(open(path).read())
    assert got["metrics"]["lat_ms_p50"] == {
        "us_per_call": 1062.5, "derived": "1.0625", "value": 1.0625}
    assert got["metrics"]["service_ms_p50"]["us_per_call"] == 0.0
    assert got["metrics"]["requests"] == {
        "us_per_call": 0.0, "derived": "64", "value": 64.0}
    assert "fused" not in got["metrics"] and "metrics" not in got["metrics"]
    assert got["meta"]["fused"] is True and got["meta"]["cycles"] is None
    assert got["meta"]["metrics"] == REPORTS["serve_memhd"]["metrics"]


def test_obs_counts_the_dispatches_after_the_recorder(tmp_path):
    # Dispatches made before the recorder do not count; those after do,
    # by kernel and tier.
    x = torch.ones((4, 16))
    ops.pack_rows(x)
    rec = record.Recorder("demo", str(tmp_path))
    ops.pack_rows(x)
    ops.pack_rows(x)
    got = rec.record()["meta"]["obs"]
    assert got == {"compiles_total": torchmon.rebuilds(),
                   "dispatch_tiers": {"pack_rows": {"torch-ref": 2}}}
    # from_report opens its recorder after the run: its delta is empty.
    path = record.from_report("demo", {"qps": 1.5}, str(tmp_path))
    assert json.loads(open(path).read())["meta"]["obs"][
        "dispatch_tiers"] == {}


def test_git_sha_outside_a_checkout_is_none(tmp_path, monkeypatch):
    monkeypatch.setattr(record, "_REPO_ROOT", tmp_path)
    assert record.git_sha() is None
    assert record.Recorder("demo", str(tmp_path)).record()["git_sha"] is None


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device as torch and nvidia-smi would report it."""
    calls, run = [], subprocess.run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: f"NVIDIA H100 80GB HBM3 #{i}")

    def smi(cmd, **kw):
        if cmd[0] != "nvidia-smi":
            return run(cmd, **kw)
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="700.00\n")
    monkeypatch.setattr(subprocess, "run", smi)
    return calls


@pytest.mark.parametrize("device,index", [(None, 0), ("cuda", 0),
                                          ("cuda:2", 2)])
def test_a_card_record_names_the_card_and_its_power_limit(fake_card,
                                                          device, index):
    got = record.device_fields(device)
    assert got == {"platform": "gpu",
                   "name": f"NVIDIA H100 80GB HBM3 #{index}",
                   "power_limit_w": 700.0, "count": 4}
    assert fake_card == [["nvidia-smi", "-i", str(index),
                          "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"]]


def test_the_cpu_record_calls_no_nvidia_smi(fake_card):
    assert record.device_fields("cpu") == CPU_DEVICE
    assert fake_card == []


@pytest.mark.parametrize("failure", [
    subprocess.CalledProcessError(9, "nvidia-smi"),
    FileNotFoundError("nvidia-smi"),
])
def test_a_failing_nvidia_smi_raises_on_a_card(fake_card, monkeypatch,
                                               tmp_path, failure):
    run = subprocess.run

    def smi(cmd, **kw):
        if cmd[0] != "nvidia-smi":
            return run(cmd, **kw)
        raise failure
    monkeypatch.setattr(subprocess, "run", smi)
    with pytest.raises(type(failure)):
        record.device_fields("cuda")
    with pytest.raises(type(failure)):
        record.from_report("demo", {"qps": 1.0}, str(tmp_path),
                           device="cuda:0")
    assert not (tmp_path / "BENCH_demo.json").exists()
