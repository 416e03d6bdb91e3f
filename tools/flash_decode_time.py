"""Device time of the ``flash_decode`` kernel at the shapes of
``chip_smoke.py``'s kernels line, for the checkout whose ``src`` is on
``PYTHONPATH`` (so two checkouts compare on one card, one process each):

    PYTHONPATH=<checkout>/src python3 tools/flash_decode_time.py

Times (``chip_smoke.time_device_ms``: CUDA events over back-to-back
calls, median of 21 samples) bfloat16 at hymba's global layer with a 32k
context (B 8, S 32,768, H 25, KV 5, Dh 64) and at the served shape (B 4,
S 320), and float32 at the first; with the decode softcap too where the
checkout's wrapper takes one. Prints one JSON line with the card's name
and power limit.
"""
import inspect
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import FD_ROW, FD_SERVE, FD_SOFTCAP, nvidia_smi  # noqa: E402
from chip_smoke import time_device_ms  # noqa: E402


def operands(shape, dtype, gen):
    dev = torch.device("cuda")
    q = torch.randn((shape["b"], shape["h"], shape["dh"]), generator=gen,
                    device=dev).to(dtype)
    k, v = (torch.randn((shape["b"], shape["s"], shape["kv"], shape["dh"]),
                        generator=gen, device=dev).to(dtype)
            for _ in range(2))
    lens = torch.full((shape["b"],), shape["s"], dtype=torch.int32,
                      device=dev)
    return q, k, v, lens


def main():
    from repro_torch.kernels import flash_decode as fd
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(5)
    caps = [None]
    if "softcap" in inspect.signature(fd.flash_decode).parameters:
        caps.append(FD_SOFTCAP)
    out = {}
    for name, shape, dtype in (("row_bf16", FD_ROW, torch.bfloat16),
                               ("serve_bf16", FD_SERVE, torch.bfloat16),
                               ("row_f32", FD_ROW, torch.float32)):
        args = operands(shape, dtype, gen)
        for cap in caps:
            kw = {} if cap is None else {"softcap": cap}
            key = name if cap is None else f"{name}_softcap"
            out[key] = time_device_ms(lambda: fd.flash_decode(*args, **kw))
    root = fd.__file__
    for _ in range(4):  # <root>/src/repro_torch/kernels/flash_decode.py
        root = os.path.dirname(root)
    print(json.dumps({"checkout": root,
                      "card": nvidia_smi("name,power.limit"), "ms": out}))


if __name__ == "__main__":
    main()
