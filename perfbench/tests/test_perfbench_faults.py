"""The check fails what it must: an answer altered where the program
produces it, on a slot's first visit or a later one, and the control (the
reference computed in TF32 in the program's place)."""
import pytest

from perfbench import control, harness
from perfbench.tests.test_perfbench_reference import CELLS

# Where each route's answers are produced, and how to alter one.
PRODUCERS = {
    "mnist1024-packed-bulk": "predict_from_features",
    "huge100k-flat-top1": "predict_from_features",
    "mnist1024-imc-bulk": "predict_imc",
    "huge100k-hier-top5": "am_search_sparse",
}


def altered(fn, at_call: int):
    calls = {"n": 0}

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls["n"] += 1
        if calls["n"] == at_call:
            if isinstance(out, tuple):   # (ids, sims): one similarity
                out[1][0, 0] += 2.0
            else:                        # classes: one class
                out[0] += 1
        return out

    return wrapper


@pytest.mark.parametrize("cell", CELLS)
def test_one_altered_answer_is_not_correct(tiny_root, monkeypatch, cell):
    from repro_torch.kernels import ops
    name = PRODUCERS[cell]
    # The first call after the warm-up: the window's first batch, which
    # every window serves however slow the host.
    monkeypatch.setattr(ops, name, altered(getattr(ops, name),
                                           harness.WARMUP_CALLS + 1))
    out = harness.run(cell, 2 ** 33 + 7, 0.5, False, root=tiny_root,
                      device="cpu", strict=False)
    assert not out["correct"]
    assert out["checks"]["rows_wrong"]["value"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_on_a_later_visit_is_not_correct(
        tiny_root, monkeypatch, counted_clock, cell):
    """A slot's second batch differs from its first: the check counts
    the row wrong although its first answers were right."""
    from repro_torch.kernels import ops
    mix = harness.resolve(cell, tiny_root).traffic
    at = harness.WARMUP_CALLS + mix["pool_rows"] // mix["batch_rows"] + 1
    name = PRODUCERS[cell]
    monkeypatch.setattr(ops, name, altered(getattr(ops, name), at))
    counted_clock(tiny_root)
    out = harness.run(cell, 2 ** 33 + 7, 0.05, False, root=tiny_root,
                      device="cpu", strict=False)
    assert out["info"]["batches"] >= at - harness.WARMUP_CALLS
    assert not out["correct"]
    assert out["checks"]["rows_wrong"]["value"] == 1


def test_the_guard_counts_the_runs_own_plain_dispatches(tiny_root):
    """A strict run stops on a dispatch of its own to the plain versions
    (every dispatch on the CPU), and not on those the process made
    before it: the control dispatches nothing of the program."""
    cell = CELLS[0]
    with pytest.raises(RuntimeError, match="plain versions"):
        harness.run(cell, 5, 0.1, False, root=tiny_root, device="cpu")
    out = control.run(cell, 5, 0.1, root=tiny_root, device="cpu")
    assert out["checks"]["plain_dispatches"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(control_root, counted_clock, cell):
    """The reference in TF32 (its operands rounded on the CPU) serves the
    window in the program's place; the run's own check fails it, over
    every pool row, on three seeds."""
    counted_clock(control_root)
    pool = harness.resolve(cell, control_root).traffic["pool_rows"]
    for seed in (1, 2, 3):
        out = control.run(cell, seed, 0.03, root=control_root, device="cpu",
                          strict=False)
        assert out["info"]["checked_rows"] == pool
        assert not out["correct"], out["checks"]
        assert out["checks"]["rows_wrong"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_on_the_card(control_root, card, cell):
    """The same with the card's own TF32 products, beside a sound run of
    the program."""
    out = control.run(cell, 1, 1.0, root=control_root)
    assert not out["correct"] and out["checks"]["rows_wrong"]["value"] > 0
    sound = harness.run(cell, 1, 1.0, False, root=control_root)
    assert sound["correct"], sound["checks"]
