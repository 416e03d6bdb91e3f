"""MEMHD end-to-end model: encode -> cluster-init -> QAIL -> deploy.

Port of ``repro.core.memhd``; the paper's Fig. 2 pipeline:

    model = MemhdModel.create(gen, enc_cfg, am_cfg)           # on the GPU
    model, hist = model.fit(gen, feats, labels)              # (a)-(c)
    deployed = model.deploy(target="packed")                 # (d)

``create`` places the model on the GPU unless ``device="cpu"`` is passed
(and raises when there is no GPU); ``fit``, ``predict`` and ``deploy``
run where the model lives. ``gen`` is a ``torch.Generator`` on that
device, or an int seed for one.

``fit`` encodes the training set once and runs the QAIL epochs
(``qail.qail_epoch_scan``; ``use_kernel=True`` runs every minibatch
through the ``qail_update`` CUDA kernel). Given
``ckpt=CheckpointManager(...)`` it checkpoints a ``MemhdTrainState``
every ``ckpt_every`` epochs and resumes from the newest valid one,
continuing bit for bit.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch import generator, on_device, resolve_device
from repro_torch.core import am as am_lib
from repro_torch.core import encoding, evaluate as eval_lib, init as init_lib
from repro_torch.core import qail
from repro_torch.core.types import EncoderConfig, MemhdConfig

log = logging.getLogger(__name__)

GenLike = Union[torch.Generator, int]


def _as_generator(gen: GenLike, device: torch.device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(f"generator on {gen.device}, model on {device}")
        return gen
    return generator(gen, device)


@dataclasses.dataclass
class MemhdTrainState:
    """Checkpointable training state: AM buffers + epoch counter. Its
    leaves flow through ``checkpoint.CheckpointManager`` under the
    reference's keys ("0/fp", "0/binary", "0/centroid_class", "1")."""

    am_state: Dict[str, torch.Tensor]
    epoch: torch.Tensor  # () int32

    @classmethod
    def create(cls, am_state: Dict[str, torch.Tensor],
               epoch: int = 0) -> "MemhdTrainState":
        device = am_state["fp"].device
        return cls(dict(am_state),
                   torch.tensor(int(epoch), dtype=torch.int32,
                                device=device))


@dataclasses.dataclass
class MemhdModel:
    """MEMHD model: encoder params + AM state + configs."""

    enc_params: Dict[str, torch.Tensor]
    am_state: Dict[str, torch.Tensor]
    enc_cfg: EncoderConfig
    am_cfg: MemhdConfig

    @property
    def device(self) -> torch.device:
        return self.am_state["fp"].device

    def _on_device(self, x) -> torch.Tensor:
        return on_device(x, self.device)

    # -- construction ----------------------------------------------------------
    @classmethod
    def create(cls, gen: GenLike, enc_cfg: EncoderConfig,
               am_cfg: MemhdConfig, *, device=None) -> "MemhdModel":
        device = resolve_device(device)
        if enc_cfg.dim != am_cfg.dim:
            raise ValueError(
                f"encoder D={enc_cfg.dim} != AM D={am_cfg.dim}")
        enc_params = encoding.init_encoder(_as_generator(gen, device),
                                           enc_cfg)
        # The AM starts empty; fit() builds it via clustering init.
        zeros = torch.zeros((am_cfg.columns, am_cfg.dim), device=device)
        owners = torch.zeros((am_cfg.columns,), dtype=torch.int32,
                             device=device)
        return cls(enc_params,
                   am_lib.make_am_state(zeros, owners, am_cfg.threshold),
                   enc_cfg, am_cfg)

    # -- pipeline stages -------------------------------------------------------
    def encode(self, feats) -> torch.Tensor:
        return encoding.encode(self.enc_params, self.enc_cfg,
                               self._on_device(feats))

    def encode_query(self, feats) -> torch.Tensor:
        return encoding.encode_query(self.enc_params, self.enc_cfg,
                                     self._on_device(feats))

    def initialize_am(self, gen: GenLike, feats, labels, *,
                      method: str = "clustering",
                      h: Optional[torch.Tensor] = None,
                      q: Optional[torch.Tensor] = None,
                      ) -> Tuple["MemhdModel", List[dict]]:
        """Clustering-based AM init (§III-A). Pass pre-encoded ``h`` /
        ``q`` to reuse an existing encode of ``feats``."""
        if method == "random":
            raise NotImplementedError(
                "random-sampling init is not ported yet "
                "(ROADMAP queue 1, item 5)")
        if method != "clustering":
            raise ValueError(f"unknown init method {method!r}")
        if h is None:
            h = self.encode(feats)
        if q is None:
            q = encoding.binarize_query(h)
        fp, owners, history = init_lib.clustering_init(
            _as_generator(gen, self.device), self.am_cfg, h,
            self._on_device(labels), queries=q)
        state = am_lib.make_am_state(fp, owners, self.am_cfg.threshold)
        return dataclasses.replace(self, am_state=state), history

    def fit(self, gen: GenLike, feats, labels, *,
            init_method: str = "clustering",
            epochs: Optional[int] = None,
            mode: str = "batched",
            refresh_every: int = 1,
            eval_feats=None, eval_labels=None,
            ckpt=None, ckpt_every: int = 1,
            use_kernel: bool = False,
            noise_sim=None, noise_mode: str = "fixed",
            cell_bits: Optional[int] = None,
            ) -> Tuple["MemhdModel", Dict]:
        """Full training pipeline: init + QAIL epochs.

        The training set is encoded ONCE; the clustering init and every
        epoch reuse the same device-resident ``h``/``q``/prebatched
        buffers, with one host sync per epoch (the miss rate).

        Args:
          init_method: "clustering" (§III-A) or "keep" (keep the current
            AM and skip initialization).
          mode: "batched" (the scan engine) or "sequential" (sample by
            sample; its miss rate is not computed and reads NaN).
          refresh_every: binary-AM refresh cadence inside the epoch.
          ckpt: optional ``checkpoint.CheckpointManager``: fit resumes
            from the newest valid ``MemhdTrainState`` (a bit-exact
            continuation) and checkpoints every ``ckpt_every`` epochs
            plus at the end.
          use_kernel: run every minibatch through the ``qail_update``
            kernel (batched mode).

        Returns (model, history) with per-epoch train miss rates and
        optional eval accuracies.
        """
        if mode not in ("batched", "sequential"):
            raise ValueError(f"unknown fit mode {mode!r}")
        if mode == "sequential" and (noise_sim is not None
                                     or cell_bits is not None):
            raise ValueError("noise_sim and cell_bits need the batched "
                             "scan engine")
        epochs = self.am_cfg.epochs if epochs is None else epochs
        labels = self._on_device(labels)

        # Encode once; init and every epoch share these buffers.
        h = self.encode(feats)
        q = encoding.binarize_query(h)

        start_epoch = 0
        init_hist: List[dict] = []
        curve: List[dict] = []
        state = None
        resumed = False
        if ckpt is not None:
            template = MemhdTrainState.create(self.am_state)
            step, tree, extra = ckpt.restore(template)
            if step is not None:
                state = tree.am_state
                start_epoch = step
                curve = list(extra.get("curve", []))
                init_hist = list(extra.get("init", []))
                resumed = True
                log.info("fit resumed from epoch %d", start_epoch)

        if state is None:
            if init_method == "keep":
                model, init_hist = self, []
                state = self.am_state
            else:
                model, init_hist = self.initialize_am(
                    gen, feats, labels, method=init_method, h=h, q=q)
                state = model.am_state
        else:
            model = dataclasses.replace(self, am_state=state)

        eval_q = (model.encode_query(eval_feats)
                  if eval_feats is not None else None)
        if eval_q is not None:
            eval_labels = self._on_device(eval_labels)

        def _save(ep, st):
            if ckpt is not None:
                ckpt.save(ep, MemhdTrainState.create(st, ep),
                          extra={"curve": curve, "init": init_hist})

        if start_epoch == 0 and not resumed:
            if eval_q is not None:
                curve.append({"epoch": 0, "eval_acc": qail.evaluate(
                    state, eval_q, eval_labels)})
            _save(0, state)

        n = h.shape[0]
        if mode == "batched":
            hb, qb, yb, mask = qail.prebatch(h, q, labels,
                                             self.am_cfg.batch_size)
        for ep in range(start_epoch + 1, epochs + 1):
            if mode == "sequential":
                state = qail.qail_epoch_sequential(state, self.am_cfg, h, q,
                                                   labels)
                miss = float("nan")
            else:
                state, n_miss = qail.qail_epoch_scan(
                    state, self.am_cfg, hb, qb, yb, mask,
                    refresh_every=refresh_every, use_kernel=use_kernel,
                    sim=noise_sim, noise_mode=noise_mode,
                    cell_bits=cell_bits)
                miss = float(n_miss) / n  # the one host sync this epoch
            rec = {"epoch": ep, "train_miss": miss}
            if eval_q is not None:
                rec["eval_acc"] = qail.evaluate(state, eval_q, eval_labels)
            curve.append(rec)
            if ep % ckpt_every == 0 or ep == epochs:
                _save(ep, state)
        model = dataclasses.replace(model, am_state=state)
        return model, {"init": init_hist, "curve": curve}

    def fit_sharded(self, *args, **kwargs):
        raise NotImplementedError(
            "data-parallel fit is not ported yet (ROADMAP queue 1, item 13)")

    def grow_classes(self, *args, **kwargs):
        raise NotImplementedError(
            "class growth is not ported yet (ROADMAP queue 1, item 14)")

    # -- inference ---------------------------------------------------------------
    def predict(self, feats) -> torch.Tensor:
        """Plain encode_query + unpacked binary-AM search (no kernel)."""
        return am_lib.predict(self.am_state["binary"],
                              self.am_state["centroid_class"],
                              self.encode_query(feats))

    def score(self, feats, labels, batch: int = 4096) -> float:
        return eval_lib.batched_accuracy(self.predict,
                                         self._on_device(feats),
                                         self._on_device(labels), batch)

    # -- deployment --------------------------------------------------------------
    def deploy(self, *, target: Optional[str] = None,
               packed: Optional[bool] = None, mode: Optional[str] = None,
               sim=None, **opts):
        """Freeze the trained model into its serving artifact through the
        deployment registry (``repro_torch.deploy.registry``):
        ``target="packed"`` (the default; the (Dp, C) uint8 1-bit
        residence, ``mode="popcount"`` or ``"unpack"``) or
        ``target="unpacked"`` (the ±1 float32 (C, D) residence searched
        by the ``am_search`` kernel). ``packed=False`` is the legacy
        spelling of ``target="unpacked"``."""
        from repro_torch.deploy import registry
        if target in (None, "digital"):
            if sim is not None:
                raise ValueError(
                    "sim= is only meaningful with target='imc'")
            target = "unpacked" if packed is False else "packed"
        elif packed is not None:
            raise ValueError(
                "packed= is the legacy digital switch; use "
                "target='packed' / target='unpacked' instead")
        if mode is not None:
            opts["mode"] = mode
        if sim is not None:
            opts["sim"] = sim
        return registry.deploy(self, target, **opts)

    # -- deployment accounting -----------------------------------------------------
    @property
    def memory_bits(self) -> int:
        """EM + AM bits, per Table I (f*D + C*D binary)."""
        return self.enc_cfg.memory_bits + self.am_cfg.am_memory_bits

    @property
    def memory_kb(self) -> float:
        return self.memory_bits / 8 / 1024

    def imc_cost(self, arr=None):
        raise NotImplementedError(
            "the IMC cost model is not ported yet (ROADMAP queue 1, item 1)")
