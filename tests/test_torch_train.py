"""The port's fault-tolerant trainer (``repro_torch.launch.train``) on the
CPU, mirroring tests/test_train_loop.py: for memhd a hard kill and an
auto-resume land on the binary AM of an uninterrupted run (sha256
digest); for the LM (mamba2-130m smoke, seq 64, batch 2) the loss falls
over 25 steps and a run killed at step 12 resumes from step 10 and ends
within 1e-5 of a clean run's loss; the event stream records the runs,
and the watchdog writes an emergency checkpoint."""
import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _run(ckpt_dir, steps, fail_at=-1, arch="memhd", *extra):
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           arch, "--smoke", "--steps", str(steps), "--ckpt-every", "5",
           "--log-every", "100", "--device", "cpu", "--ckpt-dir",
           str(ckpt_dir), "--fail-at-step", str(fail_at), *extra]
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300)


def _result(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout[proc.stdout.index("{"):])


def test_memhd_crash_and_resume_bit_exact(tmp_path):
    p1 = _run(tmp_path / "crash", 10, fail_at=7)
    assert p1.returncode == 42  # the injected hard death
    out2 = _result(_run(tmp_path / "crash", 10))  # auto-resume
    assert out2["resumed_from"] == 5  # the newest checkpoint before it
    out3 = _result(_run(tmp_path / "clean", 10))
    assert out3["resumed_from"] == 0 and out3["steps_run"] == 10
    assert out2["am_digest"] == out3["am_digest"]
    assert out2["eval_acc"] == out3["eval_acc"]
    assert out3["last_miss"] < out3["first_miss"]
    assert out3["eval_acc"] > 0.5 and out3["device"] == "cpu"
    with open(tmp_path / "crash" / "events.jsonl") as f:
        events = [json.loads(ln) for ln in f]
    kinds = [e["event"] for e in events]
    assert kinds.count("injected_failure") == 1 and "resume" in kinds
    assert kinds[-1] == "run_end"
    assert [e["step"] for e in events if e["event"] == "checkpoint"] == [
        0, 5, 10]  # the crashed run's 0 and 5, the resumed run's 10
    assert sorted(os.listdir(tmp_path / "clean")) == [
        "events.jsonl", "latest", "step_0000000000", "step_0000000005",
        "step_0000000010"]


def test_lm_archs_train_and_json_logs_are_one_object_a_line(tmp_path):
    """An LM arch trains on the CPU (the same result keys as the
    reference's run, plus the device); an arch with a modality frontend
    exits, as the reference's; and --log-json logs one JSON object per
    line."""
    cfg = train.TrainRunConfig(arch="mamba2-130m", device="cpu", steps=3,
                               seq_len=32, global_batch=2, ckpt_every=2,
                               ckpt_dir=str(tmp_path / "lm"))
    out = train.run(cfg)
    assert sorted(out) == ["device", "first_loss", "last_loss",
                           "resumed_from", "steps_run"]
    assert out["steps_run"] == 3 and out["device"] == "cpu"
    assert sorted(os.listdir(tmp_path / "lm")) == [
        "events.jsonl", "latest", "step_0000000002", "step_0000000003"]
    with pytest.raises(SystemExit, match="modality"):
        train.run(train.TrainRunConfig(arch="musicgen-medium", device="cpu",
                                       ckpt_dir=str(tmp_path / "mg")))
    # --log-json: the run logs one JSON object per line.
    import logging
    from repro_torch import obs
    try:
        out = train.main(["--arch", "memhd", "--log-json", "--device",
                          "cpu", "--steps", "2", "--ckpt-every", "1",
                          "--ckpt-dir", str(tmp_path / "json")])
        handlers = logging.getLogger().handlers
        assert any(isinstance(h.formatter, obs.JsonFormatter)
                   for h in handlers)
    finally:
        obs.setup_logging()
    assert out["device"] == "cpu"


def test_lm_loss_falls_and_crash_resume_matches_a_clean_run(tmp_path):
    lm = ("mamba2-130m", "--seq-len", "64", "--global-batch", "2")
    p1 = _run(tmp_path / "crash", 25, 12, *lm)
    assert p1.returncode == 42  # the injected hard death
    resumed = _result(_run(tmp_path / "crash", 25, -1, *lm))
    assert resumed["resumed_from"] == 10  # the newest checkpoint before it
    clean = _result(_run(tmp_path / "clean", 25, -1, *lm))
    assert clean["resumed_from"] == 0 and clean["steps_run"] == 25
    assert clean["last_loss"] < clean["first_loss"]
    assert abs(resumed["last_loss"] - clean["last_loss"]) < 1e-5
    with open(tmp_path / "crash" / "events.jsonl") as f:
        kinds = [json.loads(ln)["event"] for ln in f]
    assert kinds.count("injected_failure") == 1 and "resume" in kinds
    assert kinds[-1] == "run_end"


def test_watchdog_fires_its_handler_and_raises():
    fired = []
    with pytest.raises(TimeoutError):
        with train.StepWatchdog(0.05, lambda: fired.append(True)):
            time.sleep(2)
    assert fired == [True]
    with train.StepWatchdog(5.0, lambda: fired.append(False)):
        pass  # a step inside its deadline: the alarm is cancelled
    time.sleep(0.01)
    assert fired == [True]
