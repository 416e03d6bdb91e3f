"""Fault-tolerant checkpointing: atomic, content-verified, keep-k.

Port of ``repro.checkpoint.manager``:

* **Atomicity** — a checkpoint is written into ``step_<N>.tmp/`` and
  renamed to ``step_<N>/`` only after every leaf file and the manifest
  are on disk. A crash mid-write leaves a ``.tmp`` directory that
  restore ignores and the next save removes.
* **Verification** — the manifest records a per-file SHA-256; restore
  checks it before loading, so a torn file is detected, that checkpoint
  skipped, and the previous one used.
* **Keep-k** — old steps are pruned, newest kept; a ``latest`` link is
  refreshed atomically.
* **Extra state** — any JSON-able ``extra`` rides in the manifest.

A tree is nested dicts (keys sorted), lists, tuples and dataclasses (by
field order) over tensor, numpy or scalar leaves; leaves are keyed by
their path ("0/fp", "1", ...) — the key layout of the reference's
pytree paths. Leaves are saved as numpy ``.npy`` files; ``restore``
loads them onto the device and dtype of the template's leaves.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

_MANIFEST = "manifest.json"


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep: int = 3


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the order ``_unflatten`` consumes them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in
                _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in
                _flatten(x, prefix + (str(i),))]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [kv for i, f in enumerate(dataclasses.fields(tree)) for kv in
                _flatten(getattr(tree, f.name), prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """Rebuild ``like``'s structure from an iterator of new leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, template):
    """A loaded array in the template leaf's kind, device and dtype."""
    if isinstance(template, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=template.device, dtype=template.dtype)
    return arr


def _sha256(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class CheckpointManager:
    """Save/restore trees of tensors or numpy arrays, atomically."""

    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.cfg.directory, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.cfg.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree,
             extra: Optional[Dict[str, Any]] = None) -> str:
        """Write the checkpoint of ``step``; returns its directory."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

        files = {}
        for key, leaf in _flatten(tree):
            arr = _to_numpy(leaf)
            fn = hashlib.md5(key.encode()).hexdigest()[:16] + ".npy"
            np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
            files[key] = {
                "file": fn,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "sha256": _sha256(os.path.join(tmp, fn)),
            }

        manifest = {
            "step": step,
            "files": files,
            "extra": extra or {},
            "format_version": 1,
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)

        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic on POSIX
        self._update_latest_link(final)
        self._prune()
        log.info("saved checkpoint step=%d -> %s (%d leaves)",
                 step, final, len(files))
        return final

    def _update_latest_link(self, final: str):
        link = os.path.join(self.cfg.directory, "latest")
        tmp_link = link + ".tmp"
        try:
            if os.path.lexists(tmp_link):
                os.remove(tmp_link)
            os.symlink(os.path.basename(final), tmp_link)
            os.replace(tmp_link, link)
        except OSError:  # filesystems without symlinks: plain file
            with open(link, "w") as f:
                f.write(os.path.basename(final))

    def _prune(self):
        steps = self.all_steps()
        for step in steps[: -self.cfg.keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        # Remove stray tmp dirs of crashed writers.
        for name in os.listdir(self.cfg.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.cfg.directory, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def _verify(self, d: str, manifest: Dict) -> bool:
        for key, meta in manifest["files"].items():
            fn = os.path.join(d, meta["file"])
            if not os.path.exists(fn) or _sha256(fn) != meta["sha256"]:
                log.warning("checkpoint %s: corrupt leaf %r", d, key)
                return False
        return True

    def restore(self, tree_like, step: Optional[int] = None,
                ) -> Tuple[Optional[int], Any, Dict[str, Any]]:
        """Restore into the structure of ``tree_like``.

        Walks checkpoints newest-first until one verifies. Returns
        (step, tree, extra); (None, tree_like, {}) if nothing usable.
        A tensor leaf of the template comes back as a tensor on its
        device and dtype; any other leaf as a numpy array.
        """
        candidates = ([step] if step is not None
                      else list(reversed(self.all_steps())))
        for s in candidates:
            d = self._step_dir(s)
            mf = os.path.join(d, _MANIFEST)
            if not os.path.exists(mf):
                continue
            with open(mf) as f:
                manifest = json.load(f)
            if not self._verify(d, manifest):
                continue
            out = []
            for key, like in _flatten(tree_like):
                meta = manifest["files"].get(key)
                if meta is None:
                    log.warning("checkpoint %s: missing key %r", d, key)
                    break
                arr = np.load(os.path.join(d, meta["file"]),
                              allow_pickle=False)
                out.append(_like(arr, like))
            else:
                tree = _unflatten(tree_like, iter(out))
                log.info("restored checkpoint step=%d from %s", s, d)
                return s, tree, manifest.get("extra", {})
        return None, tree_like, {}
