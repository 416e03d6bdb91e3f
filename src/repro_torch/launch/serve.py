"""Batched LM serving driver: prefill + decode with KV/state caches.

Port of ``repro.launch.serve``: a batch of requests is prefilled token by
token into per-layer caches (GQA ring buffers or int8 rows, MLA latents,
SSM states) and then decoded with greedy or temperature sampling. Every
decode step runs each GQA layer's one-token attention through the
``flash_decode`` kernel; ``T.forward`` (prompt scoring) runs the SSD
chunks through ``ssd_chunk``. The CLI serves the token-id archs; the
modality archs (audio frames, vision patches) exit, as in the reference.

Usage (default device the GPU; ``--device cpu`` for the plain path):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --smoke --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --batch 4 --prompt-len 32 --gen 32
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import torch

log = logging.getLogger("serve")


def generate(cfg, params, prompts: torch.Tensor, gen_len: int,
             temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """prompts: (B, P) int32 on the model's device -> (B, P + gen_len)
    int32 tokens. Sampling at ``temperature`` > 0 draws from
    ``generator`` (on the prompts' device)."""
    from repro_torch.models import transformer as T

    b, p = prompts.shape
    with torch.inference_mode():
        caches = T.init_cache(cfg, b, p + gen_len, device=prompts.device)
        # Prefill token by token (prefill-as-decode, as the reference).
        logits = None
        for t in range(p):
            logits, caches = T.decode_step(
                params, cfg, {"tokens": prompts[:, t:t + 1]}, caches)
        out = [prompts]
        cur = None
        for _ in range(gen_len):
            if cur is None:
                lg = logits
            else:
                lg, caches = T.decode_step(params, cfg, {"tokens": cur},
                                           caches)
            lg = lg[..., :cfg.vocab_size]  # drop padded-vocab logits
            if temperature > 0:
                probs = torch.softmax(lg.float() / temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=generator)
            else:
                cur = torch.argmax(lg, dim=-1)[:, None]
            cur = cur.to(torch.int32)
            out.append(cur)
        return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device; default the GPU (raises without "
                         "one), 'cpu' for the plain path")
    args = ap.parse_args(argv)
    from repro_torch import generator, obs, resolve_device
    obs.setup_logging()

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import transformer as T

    device = resolve_device(args.device)
    mcfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    if mcfg.frontend != "none":
        raise SystemExit("modality archs: see examples/ drivers")
    params = T.init_params(generator(0, device), mcfg, device=device)
    prompts = torch.randint(0, mcfg.vocab_size,
                            (args.batch, args.prompt_len),
                            generator=generator(1, device), device=device,
                            dtype=torch.int32)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.time()
    out = generate(mcfg, params, prompts, args.gen,
                   temperature=args.temperature,
                   generator=generator(2, device))
    sync()
    dt = time.time() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    report = {
        "arch": mcfg.name,
        "batch": args.batch,
        "tokens_total": int(toks),
        "wall_s": round(dt, 2),
        "tok_per_s": round(toks / dt, 1),
        "sample_row": out[0, :16].tolist(),
        "device": str(device),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
