"""Batched serving example on the PyTorch/CUDA port: hybrid-cache decoding,
as examples/serve_lm.py runs it through the JAX package.

Serves a Hymba-family smoke model (the most cache-diverse arch:
sliding-window attention ring buffers, global layers and SSM states in the
same stack) with batched greedy decoding through ``decode_step``; on a GPU
every attention layer's decode runs the ``flash_decode`` kernel (the last
line lists each kernel's launches). Weights and prompts come from seeded
``torch.Generator``s.

  PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --gen 48               # the GPU
  PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --gen 48 --device cpu  # plain
"""
import argparse
import json
import time

import torch

from repro_torch import generator, kernels, resolve_device
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kernels.reset_launches()

    mcfg = get_smoke_config(args.arch)
    params = T.init_params(generator(0, device), mcfg, device=device)
    prompts = torch.randint(0, mcfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=generator(1, device), device=device,
                            dtype=torch.int32)

    t0 = time.time()
    out = generate(mcfg, params, prompts, args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"arch={mcfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"throughput: {args.batch * args.gen / dt:.1f} new tok/s "
          f"({device.type}, untrained weights)")
    for i in range(min(2, args.batch)):
        print(f"  seq[{i}]: {out[i, args.prompt_len:][:12].tolist()}...")
    print("kernel launches: " + json.dumps(kernels.launches()))
    return out


if __name__ == "__main__":
    main()
