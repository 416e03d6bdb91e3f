"""Fixtures of the benchmark's tests: a small copy of the benchmark's
folder, and the card for the ``cuda``-marked tests."""
import itertools
import json
import shutil
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent   # perfbench/

# Small sizes that keep every route and its reference on the CPU in
# seconds; widths are cut here only, never in the committed files.
TINY = {
    ("configs", "memhd-mnist-1024x1024"): {
        "dim": 128, "columns": 128, "data": {"train_rows": 1200}},
    ("configs", "memhd-huge-100k"): {
        "dim": 128, "columns": 2048, "classes": 2048,
        "data": {"prototypes": 20},
        "deploy": {"packed": {"mode": "popcount"},
                   "hierarchical": {"groups": 32, "shortlist": 4,
                                    "kmeans_iters": 8,
                                    "kmeans_sample": 1024}}},
    **{("traffic", t): {"pool_rows": 512, "batch_rows": 128}
       for t in ("bulk4k-top1-packed", "bulk4k-top5-hier",
                 "bulk4k-top1-imc")},
}


# The control's sizes: the configurations' widths (D = 1,024), with fewer
# columns and rows, so that a TF32 encode has rows to flip.
CONTROL = {
    ("configs", "memhd-mnist-1024x1024"): {
        "columns": 256, "data": {"train_rows": 2400}},
    ("configs", "memhd-huge-100k"): {
        "columns": 2048, "classes": 2048, "data": {"prototypes": 20},
        "deploy": TINY[("configs", "memhd-huge-100k")]["deploy"]},
    ("traffic", "bulk4k-top1-packed"): {"pool_rows": 4096,
                                          "batch_rows": 1024},
    ("traffic", "bulk4k-top5-hier"): {"pool_rows": 4096,
                                        "batch_rows": 1024},
    ("traffic", "bulk4k-top1-imc"): {"pool_rows": 2048,
                                       "batch_rows": 1024},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without one")


def make_tiny(dst: Path, sizes: dict = TINY) -> Path:
    """A copy of the benchmark's folder (and BENCHMARK.json) under ``dst``
    with the small sizes of ``sizes``; returns the copy's folder."""
    root = dst / "perfbench"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    shutil.copy(HERE.parent / "BENCHMARK.json", dst / "BENCHMARK.json")
    for (kind, name), changes in sizes.items():
        path = root / kind / f"{name}.json"
        data = json.loads(path.read_text())
        for key, value in changes.items():
            if isinstance(value, dict) and key == "data":
                data[key].update(value)
            else:
                data[key] = value
        path.write_text(json.dumps(data))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("perfbench"))


@pytest.fixture(scope="session")
def control_root(tmp_path_factory):
    return make_tiny(tmp_path_factory.mktemp("perfbench"), CONTROL)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def counted_clock(monkeypatch):
    """``install(root)``: each reading of the closed loop's clock then
    advances it by 1 ms (about 4 ms a batch), so the batches a window
    serves do not depend on how fast the host runs the test."""
    from perfbench import generator

    def install(root):
        ticks = itertools.count()
        monkeypatch.setattr(generator.loop(root, "closed_bulk"), "time",
                            types.SimpleNamespace(
                                perf_counter=lambda: next(ticks) * 1e-3))

    return install
