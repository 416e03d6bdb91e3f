"""Quickstart on the PyTorch/CUDA port: the full MEMHD pipeline (Fig. 2 of
the paper) through ``repro_torch``, step for step as examples/quickstart.py
runs it through the JAX package.

Encode -> cluster-init (R=0.8, confusion-driven allocation) -> 1-bit
quantization -> quantization-aware iterative learning -> one-shot
associative search, the IMC deployment accounting for the trained model,
and every deployment backend (packed, unpacked, hierarchical, multibit,
imc) with an online fold and a noise-aware fine-tune. On a GPU each step
runs the port's hand-written CUDA kernels; the last line lists how many
times each kernel was launched.

  PYTHONPATH=src python examples/quickstart_torch.py               # the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain

The deployment guide in examples/quickstart.py holds for the port: the
same ``model.deploy(target=...)`` registry and ``DeployedArtifact``
protocol, with ``repro_torch`` in place of ``repro`` and seeds (or
``torch.Generator``s) in place of ``jax.random`` keys.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import (
    EncoderConfig, ImcArrayConfig, ImcSimConfig, MemhdConfig, MemhdModel,
)
from repro_torch.data import load_dataset
from repro_torch.imcsim import multibit_finetune, noise_aware_finetune
from repro_torch.kernels import ops
from repro_torch.serve import StreamingUpdater, apply_drift


def host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = args.device
    kernels.reset_launches()

    ds = load_dataset("mnist", train_per_class=400, test_per_class=80,
                      device=dev)
    print(f"dataset: {ds.name} ({ds.source}), {ds.train_x.shape[0]} train")

    enc = EncoderConfig(kind="projection", features=ds.features, dim=128)
    am = MemhdConfig(dim=128, columns=128, classes=ds.classes,
                     init_ratio=0.8, epochs=20, lr=0.01)
    model = MemhdModel.create(0, enc, am, device=dev)

    model, hist = model.fit(1, ds.train_x, ds.train_y,
                            eval_feats=ds.test_x, eval_labels=ds.test_y)
    curve = [r for r in hist["curve"] if "eval_acc" in r]
    print(f"init acc {curve[0]['eval_acc']:.3f} -> "
          f"final {curve[-1]['eval_acc']:.3f} after {am.epochs} epochs")
    print(f"model memory: {model.memory_kb:.1f} KB "
          f"(EM {enc.memory_bits // 8 // 1024} KB + "
          f"AM {am.am_memory_bits // 8 // 1024} KB)")

    cost = model.imc_cost(ImcArrayConfig())
    print(f"IMC deployment (128x128 arrays): "
          f"{cost.total_cycles} cycles/inference "
          f"({cost.em.cycles} EM + {cost.am.cycles} AM), "
          f"{cost.total_arrays} arrays, "
          f"AM utilization {cost.am.utilization:.0%}")
    # The AM search itself is ONE array pass: the paper's one-shot claim.
    assert cost.am.cycles == 1

    # 1-bit deployment: pack the AM 8 cells/byte and serve it through the
    # popcount kernel: same predictions, 8x smaller residence.
    deployed = model.deploy(target="packed")
    acc_packed = deployed.score(ds.test_x, ds.test_y)
    acc_float = model.score(ds.test_x, ds.test_y)
    assert acc_packed == acc_float
    assert acc_packed == model.deploy(target="unpacked").score(
        ds.test_x, ds.test_y)  # every digital backend agrees
    assert acc_packed == model.deploy(target="packed", mode="unpack").score(
        ds.test_x, ds.test_y)
    print(f"packed deployment: {deployed.resident_am_bytes} B resident "
          f"AM ({deployed.am_memory_ratio:.0f}x smaller than "
          f"byte-per-cell), acc {acc_packed:.3f} == float {acc_float:.3f}")

    # The kernels' own entry points: the encoder MVM as the IMC arrays
    # compute it (one 128x128 tile a cycle), and the packed residence
    # unpacked back to the binary AM.
    h = ops.encode_mvm(ds.test_x, model.enc_params["projection"])
    assert torch.allclose(h, model.encode(ds.test_x), rtol=1e-5, atol=1e-3)
    rows = ops.unpack_bits(deployed.am_packed_t.T.contiguous())
    assert torch.equal(rows, model.am_state["binary"])

    # Serving raw features: encode + sign + bitpack in one kernel chained
    # into the packed search answers the same requests bit for bit.
    pred_fused = host(deployed.predict_features(ds.test_x))
    pred_staged = host(deployed.predict(ds.test_x))
    assert (pred_fused == pred_staged).all()
    print(f"fused feature serving: {pred_fused.shape[0]} requests, "
          f"predictions bit-exact with the staged pipeline")

    # Coarse-to-fine deployment: at its exact defaults (S = G) the
    # hierarchical index reproduces the packed scan bit for bit and adds
    # the fused top-k.
    hier = model.deploy(target="hierarchical")
    assert (host(hier.predict(ds.test_x)) == pred_staged).all()
    top5, _, _ = hier.predict_topk(ds.test_x[:256], 5)
    assert (host(top5)[:, 0] == pred_staged[:256]).all()
    print(f"hierarchical deployment ({hier.serving_mode}): bit-exact "
          f"with packed; top-5 classes served in one fused dispatch")

    # Multi-bit cells: keep 4 bits of the float shadow instead of its
    # sign, fine-tuned against the same 4-bit view the deployment serves.
    tuned4, _ = multibit_finetune(model, 3, ds.train_x, ds.train_y,
                                  cell_bits=4, epochs=4)
    int4 = tuned4.deploy(target="multibit", cell_bits=4)
    acc_int4 = int4.score(ds.test_x, ds.test_y)
    unpacked_bytes = model.deploy(target="unpacked").resident_am_bytes
    print(f"multibit deployment ({int4.serving_mode}): "
          f"{int4.resident_am_bytes} B resident "
          f"({unpacked_bytes / int4.resident_am_bytes:.1f}x under the "
          f"float AM), acc {acc_int4:.3f} vs packed {acc_packed:.3f}, "
          f"memory_bits {int4.memory_bits}")
    assert unpacked_bytes / int4.resident_am_bytes >= 2.0

    # Live updates: labeled feedback from a drifted distribution folds
    # through QAIL into a new artifact generation of the same geometry.
    test_y = host(ds.test_y)
    drifted_x = apply_drift(host(ds.test_x), 0.4)
    acc_drift = float(np.mean(host(deployed.predict(drifted_x)) == test_y))
    upd = StreamingUpdater(model, deployed, fold_epochs=2)
    upd.ingest(apply_drift(host(ds.train_x), 0.4), host(ds.train_y))
    gen1 = upd.fold()
    acc_recovered = float(np.mean(host(upd.artifact.predict(drifted_x))
                                  == test_y))
    assert gen1.shape_stable  # same (D, C): the swap rebuilds nothing
    print(f"online fold (generation {gen1.generation}, "
          f"{gen1.fold_ms:.0f} ms): drifted acc {acc_drift:.3f} -> "
          f"{acc_recovered:.3f}, swap shape-stable")

    # Noisy IMC arrays: an ideal simulated device is bit-exact with the
    # digital path; a lossy one is not, and noise-aware QAIL fine-tuning
    # on that same device recovers most of the drop.
    acc_ideal = model.deploy(target="imc", sim=ImcSimConfig()).score(
        ds.test_x, ds.test_y)
    assert acc_ideal == acc_float
    sim = ImcSimConfig(adc_bits=8, noise_sigma=0.5, seed=7)
    acc_noisy = model.deploy(target="imc", sim=sim).score(ds.test_x,
                                                          ds.test_y)
    tuned, _ = noise_aware_finetune(model, 2, ds.train_x, ds.train_y, sim,
                                    epochs=8)
    acc_tuned = tuned.deploy(target="imc", sim=sim).score(ds.test_x,
                                                          ds.test_y)
    print(f"imc deployment (8-bit ADC, sigma=0.5): {acc_float:.3f} "
          f"digital -> {acc_noisy:.3f} noisy -> {acc_tuned:.3f} after "
          f"noise-aware QAIL")
    print("kernel launches: " + json.dumps(kernels.launches()))


if __name__ == "__main__":
    main()
