"""Fault-tolerant training entry point (port of ``repro.launch.train``).

Runs the paper's QAIL trainer (``--arch memhd``) with a fault-tolerant
production substrate:

  * deterministic data, encoder and clustering init (seeded);
  * atomic checkpoints + auto-resume from the newest *valid* one;
  * a per-step wall-clock watchdog: the deadline writes an emergency
    checkpoint and exits non-zero so a cluster manager can reschedule;
  * optional failure injection (``--fail-at-step``, exit 42) that the
    tests use to prove bit-exact resume.

One "step" is one QAIL epoch (``qail.qail_epoch_scan``; the per-epoch
miss rate is the one host sync), the checkpointed state is a
``MemhdTrainState``, and the run returns ``am_digest`` (sha256 of the
binary AM), identical with and without a mid-run crash. Every epoch,
checkpoint, resume and watchdog fire is one line of ``events.jsonl``
next to the checkpoints. The LM archs of the reference's trainer are not
ported (ROADMAP queue 1, item 17).

Usage (on the GPU; ``--device cpu`` for the plain path on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch memhd \\
      --smoke --steps 10 --ckpt-dir /tmp/memhd_run
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import os
import signal
import tempfile
import time

log = logging.getLogger("train")


@dataclasses.dataclass
class TrainRunConfig:
    """The reference's run config without its LM-only fields (seq_len,
    global_batch, lr, warmup), which come with the LM trainers."""

    arch: str = "memhd"
    smoke: bool = True
    steps: int = 100
    ckpt_dir: str = ""  # empty: repro_torch_ckpt in the temp directory
    ckpt_every: int = 20
    keep: int = 3
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
    from repro_torch.obs import EventLog

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
    events = EventLog(os.path.join(ckpt_dir, "events.jsonl"))

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


# Trainers this entry point runs. The LM archs are not ported.
TRAINERS = {"memhd": run_memhd}


def run(cfg: TrainRunConfig) -> dict:
    if cfg.arch in TRAINERS:
        return TRAINERS[cfg.arch](cfg)
    raise NotImplementedError(
        f"--arch {cfg.arch}: the LM trainers are not ported yet "
        "(ROADMAP queue 1, item 17); the port trains --arch memhd")


def _setup_logging(json_mode: bool) -> None:
    if json_mode:
        raise NotImplementedError(
            "--log-json is not ported yet (ROADMAP queue 1, item 15)")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname).1s %(name)s :: "
                               "%(message)s", datefmt="%H:%M:%S",
                        force=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainRunConfig):
        name = "--" + f.name.replace("_", "-")
        if f.type == "bool" or isinstance(f.default, bool):
            ap.add_argument(name, action="store_true", default=f.default)
        else:
            ap.add_argument(name, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    cfg = TrainRunConfig(**{f.name: getattr(args, f.name)
                            for f in dataclasses.fields(TrainRunConfig)})
    _setup_logging(cfg.log_json)
    out = run(cfg)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
