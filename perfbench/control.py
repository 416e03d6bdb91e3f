"""The control of the check that decides ``correct``, for the chip.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13
        [--seconds 3] [--out FILE]

For each seed it makes a whole run of the cell (``harness.run``), with
the plain reference one precision lower than the one the configuration
states (``lower=True``: TF32 products for a float32 configuration) put
in the program's place. The run's own check then has to come out not
correct. One JSON line a seed on standard output (and appended to
``--out``): ``correct``, the rows the check counted wrong and the rows
it checked. The benchmark's own runs do not run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def run(name: str, seed: int, seconds: float, *, t_start=None,
        root=None, device: str = "cuda", strict: bool = True) -> dict:
    """A run of the cell with the reference one precision lower serving
    the window."""
    from perfbench import harness

    return harness.run(name, seed, seconds, False, t_start=t_start,
                       root=root or harness.ROOT, device=device,
                       strict=strict, make_call=harness.control_call)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:] = [str(CHECKOUT), str(CHECKOUT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != CHECKOUT /
        "perfbench"]
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    t_start = T_START
    for seed in (int(x) for x in args.seeds.split(",")):
        out = run(args.workload, seed, args.seconds, t_start=t_start)
        line = json.dumps({
            "cell": args.workload, "seed": seed, "correct": out["correct"],
            "rows_wrong": out["checks"]["rows_wrong"]["value"],
            "checked_rows": out["info"]["checked_rows"],
            "card": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
