"""Shared test fixtures.

NOTE: no XLA_FLAGS here on purpose — unit tests must see the real
1-device CPU backend. Multi-device tests spawn subprocesses with
``--xla_force_host_platform_device_count`` set (see _multidev.py).
"""
import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running training/multi-device tests "
        "(deselect with -m 'not slow')")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips without one")


@pytest.fixture(scope="session")
def key():
    return jax.random.key(0)


@pytest.fixture(scope="session")
def small_hdc_data():
    from repro.data import load_dataset
    return load_dataset("mnist", train_per_class=150, test_per_class=40)
