"""The readers of the program's own spans: their arithmetic on spans made
by hand, and one traced run on the CPU that reports them."""
import types

import pytest

from perfbench import harness, program_spans, trace
from perfbench.metrics import (idle_in_serve_share, launch_ms, ops_self_ms,
                               serve_self_ms)

S = 1_000_000_000   # ns a second


def ev(name, start_s, end_s, span_id, parent_id=0):
    return types.SimpleNamespace(
        name=name, start_ns=round(start_s * S),
        dur_ns=round(end_s * S) - round(start_s * S), span_id=span_id,
        parent_id=parent_id)


# In a window [100, 110) s: a fused call (serve -> ops -> two launches), a
# staged call (serve.predict_features over serve.predict -> ops ->
# launch), a call that began before the window, one after it.
EVENTS = [
    ev("serve.predict_features", 101.0, 101.4, 1),
    ev("ops.predict_from_features", 101.1, 101.35, 2, 1),
    ev("launch.encode_pack", 101.15, 101.2, 3, 2),
    ev("launch.am_search_packed", 101.25, 101.3, 4, 2),
    ev("serve.predict_features", 105.0, 105.5, 5),
    ev("serve.predict", 105.1, 105.5, 6, 5),
    ev("ops.predict_imc", 105.2, 105.3, 7, 6),
    ev("launch.am_search_imc", 105.22, 105.28, 8, 7),
    ev("serve.predict_features", 99.5, 100.5, 9),
    ev("serve.predict_features", 120.0, 121.0, 10),
]


def context():
    # The device runs ops over [100, 101.2), [101.3, 105.25) and
    # [105.4, 109): idle [101.2, 101.3) and [105.25, 105.4) inside serving
    # calls, [109, 110) outside.
    ops = [(100.0, 101.2, "k"), (101.3, 105.25, "k"), (105.4, 109.0, "k")]
    return trace.Context(root=None, config={}, route={}, batch_rows=1,
                         peaks={}, profile=trace.Profile((100.0, 110.0),
                                                         ops, []),
                         calls=3, rows=3, works=[], dispatch_s=0.0,
                         dispatch_calls=0)


def test_self_time_nests_and_clips_to_the_window():
    ctx = context()
    sl = program_spans.Slice(program_spans.spans(ctx, EVENTS))
    assert len(sl.outermost(program_spans.SERVE)) == 3
    # serve: 0.4 - 0.25, 0.5 - 0.4, 0.4 - 0.1, and 0.5 clipped.
    assert sl.self_ns("serve.") == pytest.approx(1.05 * S, abs=10)
    assert program_spans.per_call_ms(ctx, "serve.", True, EVENTS) == (
        pytest.approx(350.0, abs=1e-5))
    # ops: 0.25 - 0.05 - 0.05 and 0.1 - 0.06, over 3 calls.
    assert program_spans.per_call_ms(ctx, "ops.", True, EVENTS) == (
        pytest.approx(190.0 / 3, abs=1e-5))
    # launches: 0.05 + 0.05 + 0.06, over 3 calls.
    assert program_spans.per_call_ms(ctx, "launch.", False, EVENTS) == (
        pytest.approx(160.0 / 3, abs=1e-5))


def test_idle_in_serve_share_is_the_idle_inside_serving_calls():
    ctx = context()
    # 0.1 + 0.15 s of the 10 s window; the device's idle share is 12.5 %.
    assert program_spans.idle_in_serve_share(ctx, EVENTS) == (
        pytest.approx(2.5))
    assert 100 * (1 - ctx.profile.busy_s / ctx.profile.window_s) == (
        pytest.approx(12.5))


def test_no_reading_without_a_serving_call_in_the_window():
    ctx = context()
    outside = [ev("serve.predict", 120.0, 121.0, 1),
               ev("ops.pack_rows", 101.0, 101.1, 2)]
    assert program_spans.per_call_ms(ctx, "ops.", True, outside) is None
    assert program_spans.idle_in_serve_share(ctx, outside) is None


def test_a_traced_run_reports_the_program_spans(tiny_root, counted_clock,
                                                monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as program_trace

    # The CPU has no kernels: send the dispatches to the launchers, which
    # serve CPU tensors with the plain versions, so the launch spans run.
    monkeypatch.setattr(ops, "_tier", lambda x, use_kernel: "cuda")
    program_trace.TRACER.reset()
    counted_clock(tiny_root)
    out = harness.run("huge100k-flat-top1", 2**33 + 5, 0.3, True,
                      root=tiny_root, device="cpu", strict=False)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    for name in ("serve_self_ms", "ops_self_ms", "launch_ms",
                 "idle_in_serve_share"):
        assert m[name] > 0, name
    assert m["idle_in_serve_share"] <= m["device_idle_share"] + 1e-9
    # Untraced calls record nothing: the spans are the slice's calls'.
    events = program_trace.TRACER.events()
    by_id = {e.span_id: e for e in events}
    calls = [e for e in events if e.name == "serve.predict_features"]
    assert len(calls) == out["info"]["traced_calls"]
    for kernel in ("encode_pack", "am_search_packed"):
        launches = [e for e in events if e.name == f"launch.{kernel}"]
        assert len(launches) == len(calls)
        for e in launches:
            op = by_id[e.parent_id]
            assert op.name == "ops.predict_from_features"
            assert by_id[op.parent_id].name == "serve.predict_features"


@pytest.mark.parametrize("reader", [serve_self_ms, ops_self_ms, launch_ms,
                                    idle_in_serve_share])
def test_readers_read_nothing_from_a_program_without_spans(reader,
                                                           monkeypatch):
    from repro_torch.obs import trace as program_trace
    monkeypatch.setattr(program_trace, "TRACER", program_trace.Tracer())
    assert reader.read(context()) is None
