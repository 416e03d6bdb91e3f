"""String-keyed deployment-backend registry (port of
``repro.deploy.registry``).

``MemhdModel.deploy(target=..., **opts)`` dispatches through this table:
a backend is a factory ``(model, **opts) -> DeployedArtifact``
registered under a target name. ``"packed"`` and ``"unpacked"`` are
ported; asking for any other target raises the registry's "unknown
deploy target" error.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, Tuple

_BACKENDS: Dict[str, Callable] = {}

# Modules whose import registers the built-in backends.
_BUILTIN_MODULES = ("repro_torch.deploy.digital",)


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a deployment factory under ``name``."""

    def deco(factory: Callable) -> Callable:
        prev = _BACKENDS.get(name)
        if prev is not None and prev is not factory:
            raise ValueError(f"deploy backend {name!r} already registered "
                             f"(by {prev.__module__}.{prev.__qualname__})")
        _BACKENDS[name] = factory
        return factory

    return deco


def _ensure_builtins() -> None:
    for mod in _BUILTIN_MODULES:
        importlib.import_module(mod)


def available_backends() -> Tuple[str, ...]:
    """Registered target names, sorted."""
    _ensure_builtins()
    return tuple(sorted(_BACKENDS))


def get_backend(name: str) -> Callable:
    _ensure_builtins()
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown deploy target {name!r}; registered backends: "
            f"{', '.join(sorted(_BACKENDS))}") from None


def deploy(model, target: str = "packed", **opts):
    """Freeze ``model`` into the serving artifact of backend ``target``."""
    return get_backend(target)(model, **opts)
