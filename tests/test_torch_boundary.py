"""The port's boundaries: it imports neither jax nor the JAX package, it
never runs silently on the CPU, and its kernel build is reproducible."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)(\.|\s|$)",
                       re.M)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_file_of_the_port_imports_jax_or_repro():
    assert len(_port_files()) > 20
    offenders = [str(p.relative_to(ROOT)) for p in _port_files()
                 if FORBIDDEN.search(p.read_text())]
    assert offenders == []


def test_plain_cpu_path_never_loads_jax():
    code = """
import sys
import repro_torch
from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
from repro_torch.data import load_dataset
from repro_torch.launch import serve_memhd
ds = load_dataset("mnist", train_per_class=20, test_per_class=4,
                  device="cpu")
enc = EncoderConfig(features=784, dim=64)
amc = MemhdConfig(dim=64, columns=32, classes=10, epochs=1, kmeans_iters=2)
m, _ = MemhdModel.create(0, enc, amc, device="cpu").fit(1, ds.train_x,
                                                         ds.train_y)
dep = m.deploy(target="packed")
assert (dep.predict(ds.test_x) == dep.predict_features(ds.test_x)).all()
reqs = serve_memhd.synthetic_requests(ds.test_x.numpy(), 4, 3)
serve_memhd.serve_batches(dep, reqs, fused=True, depth=2)
from repro_torch.launch import train
from repro_torch.checkpoint import CheckpointManager
m2, _ = MemhdModel.create(0, enc, amc, device="cpu").fit(
    1, ds.train_x, ds.train_y, use_kernel=True)
assert (m2.am_state["fp"] == m.am_state["fp"]).all()
assert (m2.deploy(target="unpacked").predict(ds.test_x)
        == m2.deploy(mode="unpack").predict(ds.test_x)).all()
from repro_torch import imcsim
from repro_torch.core import ImcSimConfig
from repro_torch.kernels import ops
from repro_torch.launch import robustness_report
assert (m.deploy(target="imc").predict(ds.test_x)
        == m.predict(ds.test_x)).all()
m.deploy(target="multibit", cell_bits=3).predict(ds.test_x)
imcsim.noise_aware_finetune(m, 2, ds.train_x, ds.train_y,
                            ImcSimConfig(noise_sigma=0.5), epochs=1)
imcsim.multibit_finetune(m, 2, ds.train_x, ds.train_y, 4, epochs=1)
ops.encode_mvm(ds.test_x, m.enc_params["projection"])
ops.unpack_bits(dep.am_packed_t)
hier = m.deploy(target="hierarchical", shortlist=2)
hier.predict_topk(ds.test_x, 3)
serve_memhd.serve_batches(hier, reqs, topk=2)
from repro_torch import obs
from repro_torch.configs.memhd_paper import paper_config
from repro_torch.core import BaselineConfig, baselines
from repro_torch.serve import OnlineEngine, StreamingUpdater, poisson_arrivals
paper_config("mnist")
baselines.fit_baseline(0, BaselineConfig(kind="quanthd", dim=64, epochs=1),
                       ds.train_x, ds.train_y, device="cpu").score(
    ds.test_x, ds.test_y)
eng = OnlineEngine(StreamingUpdater(m, dep), max_batch=16)
eng.serve(poisson_arrivals(ds.test_x.numpy(), n_requests=4, rate_qps=1000,
                           max_size=3))
obs.update_memory_gauges()
import tempfile
from repro_torch.obs import record
with tempfile.TemporaryDirectory() as d:
    record.from_report("serve_memhd", {"qps": 1.0, "backend": "packed"}, d)
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro.")
             or k == "benchmarks" or k.startswith("benchmarks."))
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def test_plain_lm_path_never_loads_jax():
    code = """
import sys
import torch
from repro_torch import convert, generator
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer as T
for arch in ("hymba-1.5b", "mamba2-130m"):
    cfg = get_smoke_config(arch)
    params = T.init_params(generator(0, "cpu"), cfg, device="cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    out = serve.generate(cfg, params, prompts, 4)
    out = serve.generate(cfg, params, prompts, 2, temperature=0.7,
                         generator=generator(1, "cpu"))
    logits, _ = T.forward(params, cfg, {"tokens": out})
    assert logits.shape == (2, 6, cfg.padded_vocab)
    convert.lm_params_from_numpy(
        {"embed": params["embed"].numpy(), "groups": [
            {k: v for k, v in g.items() if k == "ln1"}
            for g in params["groups"]], "ln_f": params["ln_f"].numpy()},
        cfg, device="cpu")
serve.main(["--smoke", "--device", "cpu", "--batch", "1",
            "--prompt-len", "2", "--gen", "2"])
assert set(ops.dispatch_breakdown()) == {"flash_decode", "ssd_chunk"}
bad = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")
             or k == "repro" or k.startswith("repro."))
assert not bad, bad
print("OK")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_fall_back_to_the_cpu(no_gpu):
    from repro_torch import convert, resolve_device
    from repro_torch.core import EncoderConfig, MemhdConfig, MemhdModel
    from repro_torch.data import load_dataset
    from repro_torch.launch import serve_memhd
    enc, amc = EncoderConfig(features=8, dim=16), MemhdConfig(
        dim=16, columns=10, classes=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        MemhdModel.create(0, enc, amc)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_dataset("mnist", train_per_class=2, test_per_class=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_memhd.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.model_from_numpy({"projection": [[1.0]]},
                                 {"fp": [[0.0]], "binary": [[1.0]],
                                  "centroid_class": [0]},
                                 {"features": 1, "dim": 1},
                                 {"dim": 1, "columns": 1, "classes": 1})
    # An explicit CPU request is honoured.
    assert MemhdModel.create(0, enc, amc, device="cpu").device.type == "cpu"


def test_lm_entry_points_refuse_to_fall_back_to_the_cpu(no_gpu):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("mamba2-130m")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_numpy({"groups": [{}]}, cfg)
    # An explicit CPU request is honoured.
    cache = T.init_cache(cfg, 1, 4, device="cpu")
    assert cache[0][0]["ssm"]["state"].device.type == "cpu"


def test_tf32_is_off():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_kernel_build_is_keyed_by_its_sources():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        src = (_build.CSRC / name).read_text()
        assert re.search(r'extern "C" int \w+_launch\(', src), name
        assert "Replaces the TPU kernel src/repro/kernels/" in src, name
    # Every source exports its own launcher, and every launcher whose
    # signature is declared is exported by a source.
    exported = set()
    for name in _build.SOURCES:
        found = set(re.findall(r'extern "C" int (\w+_launch)\(',
                               (_build.CSRC / name).read_text()))
        assert Path(name).stem + "_launch" in found, name
        exported |= found
    assert set(_build.SIGNATURES) == exported
    # Every header a source includes is part of the library's hash.
    included = set()
    for name in _build.SOURCES + _build.HEADERS:
        included |= set(re.findall(r'#include "([^"]+)"',
                                   (_build.CSRC / name).read_text()))
    assert included == set(_build.HEADERS)
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.relative_to(ROOT / "build" / "repro_torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    # Alone in a directory, and with no GPU here, it exits non-zero and
    # prints no result.
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((tmp_path, lone), (ROOT, ROOT / "chip_smoke.py")):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
