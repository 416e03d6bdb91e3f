"""Device time of ``am_search_packed`` (popcount) on both of its routes,
tile and sweep, at B 256, 1,024, 4,096 x C 1,024, 100,000 (D = 1,024),
for the checkout whose ``src`` is on ``PYTHONPATH``:

    PYTHONPATH=src python3 tools/packed_routes_time.py

Each route's launch (``am_search_packed._launch`` of ``tile_plan`` or
``sweep_plan``) is first checked bit for bit against the plain version
on random packed operands with planted ties, then timed
(``chip_smoke.time_device_ms``: CUDA events over back-to-back calls,
median of 21 samples). Prints one JSON line with the card's name and
power limit, the route ``launch_plan`` picks at each shape and the 1-bit
bound: the measurements the sweep route's rule is set from.
"""
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import nvidia_smi, popcount_routes  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"card": nvidia_smi("name,power.limit"), "sms": sms,
                      "ms": popcount_routes(dev, sms)}))


if __name__ == "__main__":
    main()
