"""IMC mapping report + MemhdHead-over-backbone example on the PyTorch/CUDA
port (``repro_torch``), as examples/imc_mapping_report.py runs it through
the JAX package.

Part 1 reprints the paper's Table II from the closed-form cost model for
any array geometry (try --array 64 or 256 to explore beyond the paper).

Part 2 uses the MEMHD multi-centroid AM as a classification head over
pooled features from the InternVL2-family smoke backbone: it classifies
synthetic "image classes" from patch embeddings, deployable on one 128x128
array.

  PYTHONPATH=src python examples/imc_mapping_report_torch.py               # the GPU
  PYTHONPATH=src python examples/imc_mapping_report_torch.py --device cpu  # plain
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import generator, kernels, resolve_device
from repro_torch.core.head import MemhdHead
from repro_torch.core.imc import ImcArrayConfig, table2


def part1_table2(array: int):
    arr = ImcArrayConfig(rows=array, cols=array)
    print(f"=== Table II (array {array}x{array}) ===")
    for group, methods in table2(arr).items():
        print(f"\n[{group}]")
        print(f"{'method':>16} {'EM cyc':>7} {'AM cyc':>7} {'arrays':>7} "
              f"{'AM util':>8}")
        for name, cost in methods.items():
            print(f"{name:>16} {cost.em.cycles:>7} {cost.am.cycles:>7} "
                  f"{cost.total_arrays:>7} {cost.am.utilization:>8.2%}")


def part2_backbone_head(device):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    print("\n=== MemhdHead over InternVL2-family backbone features ===")
    mcfg = get_smoke_config("internvl2-2b")
    params = T.init_params(generator(0, device), mcfg, device=device)

    # Synthetic 6-class "image" task: class-dependent patch statistics.
    rng = np.random.default_rng(0)
    n_per, k = 60, 6
    protos = rng.normal(0, 1.0, (k, 4, T.VIT_DIM))
    feats, labels = [], []
    for c in range(k):
        for _ in range(n_per):
            mix = protos[c, rng.integers(0, 4)]
            feats.append(mix + rng.normal(0, 0.8,
                                          (mcfg.n_patches, T.VIT_DIM)))
            labels.append(c)
    feats = torch.tensor(np.stack(feats), dtype=torch.float32, device=device)
    labels = torch.tensor(labels, dtype=torch.int32, device=device)

    # Backbone forward -> pooled hidden features.
    toks = torch.zeros((feats.shape[0], 8), dtype=torch.int32, device=device)
    batch = {"tokens": toks, "patch_feats": feats, "targets": toks}
    hidden = []
    with torch.inference_mode():
        for i in range(0, feats.shape[0], 64):
            sub = {k2: v[i:i + 64] for k2, v in batch.items()}
            _, aux = T.forward(params, mcfg, sub)
            hidden.append(MemhdHead.pool(aux["final_hidden"]))
    pooled = torch.cat(hidden, dim=0)

    n_train = int(0.8 * pooled.shape[0])
    perm = torch.randperm(pooled.shape[0], generator=generator(2, device),
                          device=device)
    tr, te = perm[:n_train], perm[n_train:]

    head = MemhdHead.create(3, pooled.shape[-1], n_classes=k, dim=128,
                            columns=128, epochs=15, device=device)
    head, _ = head.fit(4, pooled[tr], labels[tr])
    acc = head.score(pooled[te], labels[te])
    print(f"head accuracy on synthetic 6-class task: {acc:.3f} "
          f"(memory {head.memory_kb:.1f} KB, one-shot search on one "
          f"128x128 array)")
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--array", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    kernels.reset_launches()
    part1_table2(args.array)
    part2_backbone_head(resolve_device(args.device))
    print("kernel launches: " + json.dumps(kernels.launches()))


if __name__ == "__main__":
    main()
