"""Fault-tolerant training entry point (port of ``repro.launch.train``).

Runs a training loop with the reference's production substrate:

  * deterministic, checkpointable data (the LM pipeline's position rides
    in the checkpoint manifest);
  * atomic checkpoints + auto-resume from the newest *valid* one;
  * a per-step wall-clock watchdog: the deadline writes an emergency
    checkpoint and exits non-zero so a cluster manager can reschedule;
  * optional failure injection (``--fail-at-step``, exit 42) that the
    tests use to prove resume.

Two trainer families run under the same driver:

  * the LM archs of ``repro_torch.configs`` (per-step AdamW training
    through ``distributed.steps.make_train_step``: ``loss_fn``, autograd,
    AdamW; the SSM layers through the ``ssd_chunk`` kernel on the GPU),
    and
  * ``--arch memhd``, the paper's QAIL trainer: one "step" is one QAIL
    epoch (``qail.qail_epoch_scan``; the per-epoch miss rate is the one
    host sync), the checkpointed state is a ``MemhdTrainState``, and the
    run returns ``am_digest`` (sha256 of the binary AM), identical with
    and without a mid-run crash.

Every step or epoch, checkpoint, resume and watchdog fire is one line of
``events.jsonl`` next to the checkpoints.

Usage (on the GPU; ``--device cpu`` for the plain path on the CPU;
``--no-smoke`` for the published config at full width and depth):
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --no-smoke --steps 50 --ckpt-dir /tmp/run1
  PYTHONPATH=src python -m repro_torch.launch.train --arch memhd \\
      --smoke --steps 10 --ckpt-dir /tmp/memhd_run
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import math
import os
import signal
import tempfile
import time

from repro_torch import obs

log = logging.getLogger("train")


@dataclasses.dataclass
class TrainRunConfig:
    """The reference's run config, plus the device to run on."""

    arch: str = "memhd"
    smoke: bool = True
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    ckpt_dir: str = ""  # empty: repro_torch_ckpt in the temp directory
    ckpt_every: int = 20
    keep: int = 3
    lr: float = 3e-4
    warmup: int = 20
    log_every: int = 10
    step_deadline_s: float = 300.0
    fail_at_step: int = -1  # fault-injection for tests
    seed: int = 0
    log_json: bool = False  # structured one-JSON-per-line logging
    device: str = "cuda"    # "cpu" runs the plain path on the CPU


class StepWatchdog:
    """SIGALRM-based per-step deadline (single-host stand-in for the
    pod-level heartbeat/reschedule machinery)."""

    def __init__(self, deadline_s: float, on_timeout):
        self.deadline = deadline_s
        self.on_timeout = on_timeout

    def __enter__(self):
        def handler(signum, frame):
            self.on_timeout()
            raise TimeoutError("train step exceeded deadline")

        self._prev = signal.signal(signal.SIGALRM, handler)
        signal.setitimer(signal.ITIMER_REAL, self.deadline)
        return self

    def __exit__(self, *exc):
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, self._prev)
        return False


def _ckpt_dir(cfg: TrainRunConfig) -> str:
    return cfg.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "repro_torch_ckpt")


def run_memhd(cfg: TrainRunConfig) -> dict:
    """QAIL training with checkpoints, watchdog and auto-resume.

    The dataset, encoder and clustering init are deterministic in
    ``cfg.seed``, so a restore of the newest ``MemhdTrainState``
    continues the run bit-exactly.
    """
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.core import (
        EncoderConfig, MemhdConfig, MemhdModel, encoding, qail,
    )
    from repro_torch.core.memhd import MemhdTrainState
    from repro_torch.data import load_dataset

    device = resolve_device(cfg.device)
    if cfg.smoke:
        ds = load_dataset("mnist", train_per_class=120, test_per_class=30,
                          seed=cfg.seed, device=device)
        enc = EncoderConfig(kind="projection", features=ds.features,
                            dim=256)
        amc = MemhdConfig(dim=256, columns=64, classes=ds.classes,
                          kmeans_iters=8, lr=0.02, batch_size=256,
                          seed=cfg.seed)
    else:
        ds = load_dataset("mnist", train_per_class=1000,
                          test_per_class=200, seed=cfg.seed, device=device)
        enc = EncoderConfig(kind="projection", features=ds.features,
                            dim=512)
        amc = MemhdConfig(dim=512, columns=128, classes=ds.classes,
                          kmeans_iters=25, lr=0.02, batch_size=256,
                          seed=cfg.seed)

    model = MemhdModel.create(cfg.seed, enc, amc, device=device)
    h = model.encode(ds.train_x)
    q = encoding.binarize_query(h)
    n = h.shape[0]
    epochs = cfg.steps

    ckpt_dir = _ckpt_dir(cfg)
    ckpt = CheckpointManager(CheckpointConfig(ckpt_dir, keep=cfg.keep))
    events = obs.EventLog(os.path.join(ckpt_dir, "events.jsonl"))

    def timed_save(step, tree, extra):
        t0 = time.perf_counter()
        ckpt.save(step, tree, extra=extra)
        events.emit("checkpoint", step=step,
                    dur_s=round(time.perf_counter() - t0, 4),
                    emergency=bool(extra.get("emergency", False)))

    template = MemhdTrainState.create(model.am_state)
    restored_epoch, tree, extra = ckpt.restore(template)
    miss_hist = []
    if restored_epoch is not None:
        state = tree.am_state
        start_epoch = restored_epoch
        miss_hist = list(extra.get("miss", []))
        log.info("resumed memhd from epoch %d", start_epoch)
        events.emit("resume", step=start_epoch)
    else:
        m_init, _ = model.initialize_am(cfg.seed + 1, ds.train_x,
                                        ds.train_y, h=h, q=q)
        state = m_init.am_state
        start_epoch = 0
        timed_save(0, MemhdTrainState.create(state, 0),
                   extra={"miss": miss_hist})

    hb, qb, yb, mask = qail.prebatch(h, q, ds.train_y, amc.batch_size)

    def host_copy(st):
        return {k: v.detach().to("cpu", copy=True) for k, v in st.items()}

    # Emergency-checkpoint source: a host copy of the last completed
    # epoch, so the watchdog never saves a half-updated AM.
    last_state = [host_copy(state)]
    last_epoch = [start_epoch]

    def emergency_ckpt():
        log.error("watchdog fired: writing emergency memhd checkpoint")
        events.emit("watchdog", step=last_epoch[0],
                    deadline_s=cfg.step_deadline_s)
        timed_save(last_epoch[0],
                   MemhdTrainState.create(last_state[0], last_epoch[0]),
                   extra={"miss": miss_hist, "emergency": True})

    t_start = time.time()
    for ep in range(start_epoch, epochs):
        t_ep = time.perf_counter()
        with StepWatchdog(cfg.step_deadline_s, emergency_ckpt):
            state, n_miss = qail.qail_epoch_scan(state, amc, hb, qb, yb,
                                                 mask)
            miss_rate = float(n_miss) / n  # the one host sync this epoch
        dur_s = time.perf_counter() - t_ep
        miss_hist.append(miss_rate)
        last_state[0] = host_copy(state)
        last_epoch[0] = ep + 1
        events.emit("epoch", step=ep + 1, miss=round(miss_rate, 6),
                    dur_s=round(dur_s, 4),
                    samples_per_sec=round(n / dur_s, 1) if dur_s else None)
        if (ep + 1) % cfg.log_every == 0:
            log.info("epoch %d miss %.4f (%.2f s/epoch)", ep + 1,
                     miss_rate,
                     (time.time() - t_start) / (ep + 1 - start_epoch))
        if (ep + 1) % cfg.ckpt_every == 0 or ep + 1 == epochs:
            timed_save(ep + 1, MemhdTrainState.create(state, ep + 1),
                       extra={"miss": miss_hist})
        if cfg.fail_at_step == ep + 1:
            log.error("injected failure at epoch %d", ep + 1)
            events.emit("injected_failure", step=ep + 1)
            os._exit(42)  # simulate a hard node death

    trained = dataclasses.replace(model, am_state=state)
    eval_acc = trained.score(ds.test_x, ds.test_y)
    digest = hashlib.sha256(
        state["binary"].cpu().numpy().tobytes()).hexdigest()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t_start
    events.emit("run_end", steps_run=epochs - start_epoch,
                resumed_from=start_epoch, eval_acc=eval_acc,
                wall_s=round(dt, 3))
    events.close()
    return {
        "first_miss": miss_hist[0] if miss_hist else None,
        "last_miss": miss_hist[-1] if miss_hist else None,
        "steps_run": epochs - start_epoch,
        "resumed_from": start_epoch,
        "eval_acc": eval_acc,
        "am_digest": digest,
        "samples_per_sec": (n * (epochs - start_epoch) / dt
                            if dt > 0 and epochs > start_epoch else None),
        "device": str(device),
    }


def run_lm(cfg: TrainRunConfig) -> dict:
    """AdamW training of an LM arch with checkpoints, watchdog and
    auto-resume. Params come from ``cfg.seed``; the data stream's
    position is checkpointed, so a resumed run sees the batches an
    uninterrupted run would."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointConfig, CheckpointManager
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data.lm import LmDataConfig, PipelineState, next_batch
    from repro_torch.distributed.steps import (
        init_train_state, make_train_step,
    )
    from repro_torch.optim import AdamWConfig, ScheduleConfig, make_schedule

    device = resolve_device(cfg.device)
    mcfg = (get_smoke_config(cfg.arch) if cfg.smoke
            else get_config(cfg.arch))
    if mcfg.frontend != "none":
        raise SystemExit(
            f"{cfg.arch} needs modality inputs; use examples/ drivers")

    opt_cfg = AdamWConfig(lr=cfg.lr)
    sched = make_schedule(ScheduleConfig(
        warmup_steps=cfg.warmup, total_steps=cfg.steps))
    dcfg = LmDataConfig(vocab_size=mcfg.vocab_size, seq_len=cfg.seq_len,
                        global_batch=cfg.global_batch)

    params, opt_state = init_train_state(cfg.seed, mcfg, opt_cfg,
                                         device=device)
    pipe = PipelineState(seed=cfg.seed)
    start_step = 0

    ckpt_dir = _ckpt_dir(cfg)
    ckpt = CheckpointManager(CheckpointConfig(ckpt_dir, keep=cfg.keep))
    events = obs.EventLog(os.path.join(ckpt_dir, "events.jsonl"))

    def timed_save(step, tree, extra):
        t0 = time.perf_counter()
        ckpt.save(step, tree, extra=extra)
        events.emit("checkpoint", step=step,
                    dur_s=round(time.perf_counter() - t0, 4),
                    emergency=bool(extra.get("emergency", False)))

    restored_step, tree, extra = ckpt.restore(
        {"params": params, "opt": opt_state})
    if restored_step is not None:
        params, opt_state = tree["params"], tree["opt"]
        pipe = PipelineState.from_json(extra["pipeline"])
        start_step = restored_step
        log.info("resumed from step %d", start_step)
        events.emit("resume", step=start_step)

    step_fn = make_train_step(mcfg, opt_cfg, sched)

    # Emergency-checkpoint source: the last completed step's params,
    # state and stream position (the step returns new trees, so these
    # stay whole while a step is in flight).
    last = {"step": start_step, "params": params, "opt": opt_state,
            "pipe": pipe}

    def emergency_ckpt():
        log.error("watchdog fired: writing emergency checkpoint")
        events.emit("watchdog", step=last["step"],
                    deadline_s=cfg.step_deadline_s)
        timed_save(last["step"], {"params": last["params"],
                                  "opt": last["opt"]},
                   extra={"pipeline": last["pipe"].to_json(),
                          "emergency": True})

    losses = []
    t_start = time.time()
    for step in range(start_step, cfg.steps):
        t_step = time.perf_counter()
        batch_np, pipe = next_batch(dcfg, pipe)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_np.items()}
        with StepWatchdog(cfg.step_deadline_s, emergency_ckpt):
            params, opt_state, metrics = step_fn(params, opt_state, batch,
                                                 step)
            loss = float(metrics["loss"])  # the one host sync a step
        losses.append(loss)
        last.update(step=step + 1, params=params, opt=opt_state, pipe=pipe)
        if not math.isfinite(loss):
            events.emit("diverged", step=step, loss=loss)
            raise FloatingPointError(f"loss diverged at step {step}")
        if (step + 1) % cfg.log_every == 0:
            dt_step = time.perf_counter() - t_step
            log.info("step %d loss %.4f (%.2f s/step)", step + 1, loss,
                     (time.time() - t_start) / (step + 1 - start_step))
            events.emit("step", step=step + 1, loss=round(loss, 6),
                        dur_s=round(dt_step, 4),
                        tokens_per_sec=round(
                            cfg.global_batch * cfg.seq_len / dt_step, 1)
                        if dt_step else None)
        if (step + 1) % cfg.ckpt_every == 0 or step + 1 == cfg.steps:
            timed_save(step + 1, {"params": params, "opt": opt_state},
                       extra={"pipeline": pipe.to_json()})
        if cfg.fail_at_step == step + 1:
            log.error("injected failure at step %d", step + 1)
            events.emit("injected_failure", step=step + 1)
            os._exit(42)  # simulate a hard node death

    events.emit("run_end", steps_run=len(losses),
                resumed_from=start_step,
                wall_s=round(time.time() - t_start, 3))
    events.close()
    return {
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "steps_run": len(losses),
        "resumed_from": start_step,
        "device": str(device),
    }


# Non-LM trainers that run under the same fault-tolerant driver.
TRAINERS = {"memhd": run_memhd}


def run(cfg: TrainRunConfig) -> dict:
    if cfg.arch in TRAINERS:
        return TRAINERS[cfg.arch](cfg)
    return run_lm(cfg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainRunConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    cfg = TrainRunConfig(**{f.name: getattr(args, f.name)
                            for f in dataclasses.fields(TrainRunConfig)})
    obs.setup_logging(json_mode=cfg.log_json)
    out = run(cfg)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
