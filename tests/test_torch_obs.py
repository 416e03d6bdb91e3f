"""The port's observability layer against the JAX package's, on the CPU.

The same operations through both packages' metrics registries give the
same snapshot and the same Prometheus text; the same spans through both
tracers export the same names, args and nesting (timestamps differ).
``torchmon`` (the port's ``jaxmon``) skips memory gauges on the CPU and
counts kernel builds, and the serving CLI writes its metrics snapshot
and Chrome trace.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import metrics as jmetrics  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402
from repro_torch.obs import torchmon  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402


def drive_registry(mod, seed):
    """One seeded sequence of registry operations on a fresh registry of
    ``mod`` (either package's ``obs.metrics``)."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("requests_total", "requests served")
    g = reg.gauge("queue_depth", "admission queue length")
    h = reg.histogram("batch_ms", "per-batch latency")
    h2 = reg.histogram("fold_ms", buckets=mod.log_buckets(0.1, 100.0, 2))
    stages = ["total", "queue", "service"]
    for _ in range(200):
        op = int(rng.integers(0, 5))
        if op == 0:
            c.inc(float(rng.integers(1, 4)), kernel="am_search_packed",
                  tier=["cuda", "torch-ref"][int(rng.integers(0, 2))])
        elif op == 1:
            g.set(float(rng.integers(0, 50)))
        elif op == 2:
            g.add(float(rng.random()), stage=stages[int(rng.integers(0, 3))])
        elif op == 3:
            h.observe(float(10.0 ** rng.uniform(-3, 5)),
                      stage=stages[int(rng.integers(0, 3))])
        else:
            h2.observe(float(rng.exponential(5.0)))
    c.inc(geometry="B=4,C=5,D=32")  # commas and '=' inside a label value
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registries_give_the_same_snapshot_and_exposition(seed):
    jreg, treg = drive_registry(jmetrics, seed), drive_registry(tmetrics,
                                                                seed)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.render_prometheus() == jreg.render_prometheus()
    json.dumps(treg.snapshot())
    for reg in (jreg, treg):
        reg.reset()
    assert treg.snapshot() == jreg.snapshot()


def test_buckets_and_registry_errors_match():
    for args in ((0.01, 10_000.0, 4), (0.1, 100.0, 1), (1e-3, 1e3, 3)):
        assert tmetrics.log_buckets(*args) == jmetrics.log_buckets(*args)
    for mod in (jmetrics, tmetrics):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        reg.histogram("h", buckets=[1.0, 2.0])
        with pytest.raises(ValueError, match="different buckets"):
            reg.histogram("h", buckets=[1.0, 3.0])
        with pytest.raises(ValueError, match="negative"):
            reg.counter("x").inc(-1)
        with pytest.raises(ValueError):
            mod.log_buckets(0.0, 1.0)


def test_timed_ms_observes_its_elapsed_time():
    reg = tmetrics.Registry()
    h = reg.histogram("t_ms")
    with tmetrics.timed_ms(h, stage="x") as elapsed:
        pass
    snap = reg.snapshot()["t_ms"]["values"]['stage="x"']
    assert snap["count"] == 1 and snap["sum"] == pytest.approx(elapsed(),
                                                             abs=1.0)


def drive_tracer(mod):
    tr = mod.Tracer()
    with tr.span("serve", requests=3, depth=2):
        for i in range(2):
            with tr.span("host_prep", batch=i, requests=1):
                with tr.span("pad", batch=i):
                    pass
            with tr.span("dispatch", batch=i, rows=8, device=True):
                pass
        with tr.span("device_wait", batch=0, obj=object):
            pass
    try:
        with tr.span("failing"):
            raise RuntimeError("x")
    except RuntimeError:
        pass
    return tr


def _shape(trace):
    """Names, args (ids kept: both tracers number spans alike) and the
    nesting, without timestamps."""
    return [(e["name"], e["ph"], e["tid"],
             {k: v for k, v in e["args"].items()})
            for e in trace["traceEvents"]]


def test_trace_exports_the_same_names_args_and_nesting(tmp_path):
    jt, tt = drive_tracer(jtrace), drive_tracer(ttrace)
    jd, td = jt.to_chrome_trace(), tt.to_chrome_trace()
    assert _shape(td) == _shape(jd)
    assert td["otherData"] == jd["otherData"] == {"dropped_events": 0}
    names = {e["args"]["span_id"]: e["name"] for e in td["traceEvents"]}
    parents = {e["name"]: names.get(e["args"]["parent_id"])
               for e in td["traceEvents"]}
    assert parents["pad"] == "host_prep" and parents["dispatch"] == "serve"
    assert parents["serve"] is None and parents["failing"] is None
    path = tt.export(str(tmp_path / "sub" / "trace.json"))
    assert _shape(json.loads(open(path).read())) == _shape(jd)


def test_tracer_bounds_and_disable_match():
    for mod in (jtrace, ttrace):
        tr = mod.Tracer(max_events=3)
        for _ in range(5):
            with tr.span("s"):
                pass
        assert len(tr.events()) == 3 and tr.dropped == 2
        tr.reset()
        tr.enabled = False
        with tr.span("off"):
            pass
        assert tr.events() == [] and tr.current_span_id() == 0


def test_device_span_shows_in_a_torch_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    tr = ttrace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("fold", device=True, generation=1):
            torch.ones(4) + 1
    assert "fold" in {ev.key for ev in prof.key_averages()}
    assert [e.name for e in tr.events()] == ["fold"]


# -- torchmon -----------------------------------------------------------------

def test_torchmon_install_is_idempotent_and_gauges_skip_the_cpu(
        monkeypatch):
    torchmon.install()
    torchmon.install()
    assert torchmon.installed()
    snap = obs.snapshot()
    assert snap["kernel_builds_total"]["type"] == "counter"
    assert snap["cuda_graph_captures_total"]["type"] == "counter"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fam = obs.REGISTRY.get("torch_device_memory_bytes")
    if fam is not None:
        fam.clear()
    assert torchmon.update_memory_gauges() == {}
    fam = obs.REGISTRY.get("torch_device_memory_bytes")
    assert fam is not None and list(fam.series()) == []


def test_torchmon_gauges_read_memory_stats_per_device(monkeypatch):
    stats = {"allocated_bytes.all.current": 512, "num_alloc_retries": 0,
             "note": "not a number"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: stats)
    out = torchmon.update_memory_gauges()
    assert out == {"cuda:0": {"allocated_bytes.all.current": 512.0,
                              "num_alloc_retries": 0.0}}
    assert obs.gauge("torch_device_memory_bytes").value(
        device="cuda:0", stat="allocated_bytes.all.current") == 512.0


def test_a_counted_build_fails_assert_no_rebuilds(monkeypatch, tmp_path):
    # build() counts a build only where it runs nvcc: a cached library is
    # no rebuild, a fresh one is.
    lib = tmp_path / "lib.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    lib.write_bytes(b"")
    with torchmon.assert_no_rebuilds("cached"):
        assert _build.build() == lib
    lib.unlink()
    monkeypatch.setattr(_build, "_nvcc", lambda: "/nonexistent/nvcc")
    with pytest.raises(torchmon.SteadyStateError, match="steady"):
        with torchmon.assert_no_rebuilds("steady window"):
            with pytest.raises(OSError):
                _build.build()  # counted, then nvcc fails to start
    with torchmon.count_rebuilds() as delta:
        obs.counter(torchmon.CAPTURES).inc()  # a graph capture counts too
    assert delta() == 1


def test_dispatch_counter_lives_in_the_registry():
    ops.reset_dispatch()
    q = torch.ones(3, 16)
    am = torch.ones(4, 16)  # (C, D)
    ops.am_search(q, am)
    ops.am_search(q, am, use_kernel=False)
    assert ops.dispatch_breakdown() == {"am_search": {"torch-ref": 2}}
    series = dict((tuple(sorted(lab.items())), v) for lab, v in
                  obs.REGISTRY.get("kernel_dispatch_total").series())
    assert series == {(("geometry", "B=3,C=4,D=16"), ("kernel", "am_search"),
                       ("tier", "torch-ref")): 2.0}
    ops.reset_dispatch()
    assert ops.dispatch_breakdown() == {}


def test_serving_cli_writes_metrics_and_trace(tmp_path):
    from repro_torch.launch import serve_memhd
    m, tr = tmp_path / "metrics.json", tmp_path / "trace.json"
    obs.TRACER.reset()
    rep = serve_memhd.main(["--smoke", "--device", "cpu", "--requests", "6",
                            "--metrics-out", str(m), "--trace-out",
                            str(tr), "--record-dir", str(tmp_path / "rec")])
    assert rep["metrics"]["recompiles_steady_state"] == 0
    assert rep["metrics"]["compiles_total"] == torchmon.rebuilds()
    assert "dispatch_tiers" in rep["metrics"]
    snap = json.loads(m.read_text())
    assert snap["serve_requests_total"]["values"][""] >= 12  # warm + timed
    assert snap["serve_batch_ms"]["type"] == "histogram"
    assert "kernel_dispatch_total" in snap
    names = {e["name"] for e in json.loads(tr.read_text())["traceEvents"]}
    assert {"warmup", "serve", "host_prep", "pad", "dispatch",
            "device_wait"} <= names
    # The --record-dir record: the report's numbers as metrics, its
    # dispatch tiers in meta, on the CPU.
    rec = json.loads((tmp_path / "rec" / "BENCH_serve_memhd.json")
                     .read_text())
    assert rec["bench"] == "serve_memhd" and rec["schema_version"] == 1
    assert rec["metrics"]["rows_per_s"]["value"] == rep["rows_per_s"]
    assert (rec["metrics"]["lat_ms_p50"]["us_per_call"]
            == rep["lat_ms_p50"] * 1e3)
    assert rec["metrics"]["lat_ms_p50"]["value"] == rep["lat_ms_p50"]
    assert (rec["meta"]["metrics"]["dispatch_tiers"]
            == rep["metrics"]["dispatch_tiers"])
    assert rec["meta"]["obs"] == {"compiles_total": torchmon.rebuilds(),
                                  "dispatch_tiers": {}}
    assert rec["device"] == {"platform": "cpu", "name": "cpu",
                             "power_limit_w": None, "count": 1}
