"""Run one cell of BENCHMARK.json on the GPU and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics (host clock), ``--trace 1`` its per-layer metrics (a profiled
slice of the window). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number the
run compared beside its limit (the same on the last lines of standard
error). The run stops with an error, printing no result, where there is
no CUDA device or fewer than the cell asks for, where a kernel dispatch
went to the program's plain versions or a kernel was built inside the
window, or where jax, jaxlib, flax or the JAX package ``repro`` is
loaded in this process after the window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # The script's own folder must not shadow top-level modules (its
    # ``trace.py``); the checkout root gives ``perfbench``, src/ the port.
    sys.path[:] = [str(CHECKOUT), str(CHECKOUT / "src")] + [
        q for q in sys.path if Path(q or ".").resolve() != CHECKOUT /
        "perfbench"]
    cache = CHECKOUT / "build" / "perfbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)

    import torch
    from perfbench import harness

    torch.set_num_threads(1)  # one host thread drives the card

    cell = harness.resolve(args.workload)
    chips = cell.spec["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"perfbench: forbidden modules loaded: {loaded}",
              file=sys.stderr)
        return 3
    info = out.pop("info")
    print(f"perfbench: {args.workload} seed {args.seed}: {info}",
          file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
