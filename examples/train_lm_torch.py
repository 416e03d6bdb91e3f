"""End-to-end LM training driver on the PyTorch/CUDA port, as
examples/train_lm.py runs it through the JAX package.

Trains the *full* mamba2-130m config (or any --arch, or a --preset small
model for quick runs) on the synthetic Zipf+motif stream with the port's
trainer: AdamW + cosine schedule, atomic checkpoints, auto-resume,
watchdog. On a GPU the SSM layers' chunks run the ``ssd_chunk`` kernel
(the last line lists each kernel's launches). The loss dropping over a
run longer than the warm-up is the acceptance signal.

  PYTHONPATH=src python examples/train_lm_torch.py --preset small --steps 300
  PYTHONPATH=src python examples/train_lm_torch.py --arch mamba2-130m --preset full --steps 200
  PYTHONPATH=src python examples/train_lm_torch.py --preset smoke --steps 3 --device cpu

A run resumes from the newest checkpoint in --ckpt-dir (default
``repro_torch_train_lm`` in the temp directory); give a fresh directory
for a fresh run.
"""
import argparse
import json
import logging
import os
import tempfile

from repro_torch import kernels
from repro_torch.launch.train import TrainRunConfig, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--preset", choices=["full", "small", "smoke"],
                    default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")

    cfg = TrainRunConfig(
        arch=args.arch,
        smoke=args.preset in ("small", "smoke"),
        steps=args.steps,
        seq_len=args.seq_len,
        global_batch=args.batch,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=max(20, args.steps // 5),
        device=args.device,
    )
    kernels.reset_launches()
    out = run(cfg)
    drop = (out["first_loss"] or 0) - (out["last_loss"] or 0)
    print(f"\nloss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"(drop {drop:+.3f}) over {out['steps_run']} steps")
    if cfg.steps > cfg.warmup:
        assert drop > 0, "loss did not decrease"
    else:  # the learning rate is still ramping from 0
        print(f"no loss check: the run ends inside the {cfg.warmup}-step "
              f"warm-up")
    print("kernel launches: " + json.dumps(kernels.launches()))
    return out


if __name__ == "__main__":
    main()
