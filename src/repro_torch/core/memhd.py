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

import numpy as np
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
                      init_seed: Optional[int] = None,
                      ) -> Tuple["MemhdModel", List[dict]]:
        """Clustering-based (or random-sampling baseline) AM init
        (§III-A). Pass pre-encoded ``h`` / ``q`` to reuse an existing
        encode of ``feats``. ``init_seed`` is the numpy seed of
        ``method="random"`` (default: drawn from ``gen``)."""
        if method not in ("clustering", "random"):
            raise ValueError(f"unknown init method {method!r}")
        if h is None:
            h = self.encode(feats)
        if q is None:
            q = encoding.binarize_query(h)
        gen = _as_generator(gen, self.device)
        labels = self._on_device(labels)
        if method == "clustering":
            fp, owners, history = init_lib.clustering_init(
                gen, self.am_cfg, h, labels, queries=q)
        else:
            fp, owners = init_lib.random_sampling_init(
                gen, self.am_cfg, h, labels, seed=init_seed)
            history = []
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
            cell_bits: Optional[int] = None, noise_sampler=None,
            init_seed: Optional[int] = None,
            ) -> Tuple["MemhdModel", Dict]:
        """Full training pipeline: init + QAIL epochs.

        The training set is encoded ONCE; the clustering init and every
        epoch reuse the same device-resident ``h``/``q``/prebatched
        buffers, with one host sync per epoch (the miss rate).

        Args:
          init_method: "clustering" (§III-A), "random" (the Fig. 5
            baseline: sampled training hypervectors) or "keep" (keep the
            current AM and skip initialization).
          mode: "batched" (the scan engine) or "sequential" (sample by
            sample; its miss rate is not computed and reads NaN).
          refresh_every: binary-AM refresh cadence inside the epoch.
          ckpt: optional ``checkpoint.CheckpointManager``: fit resumes
            from the newest valid ``MemhdTrainState`` (a bit-exact
            continuation) and checkpoints every ``ckpt_every`` epochs
            plus at the end.
          use_kernel: run every minibatch through the ``qail_update``
            kernel (batched mode).
          noise_sim: optional ``ImcSimConfig`` — noise-aware QAIL: the
            sims MVM sees a device-perturbed view of the binary AM
            (batched mode; ``qail.qail_epoch_scan``).
          noise_mode: "fixed" trains against the one device instance
            ``deploy(target="imc", sim=noise_sim)`` burns (its key is
            ``imcsim.device.device_instance_key``); "fresh" redraws per
            batch, under key (seed, epoch, batch).
          cell_bits: optional 2..8 — multi-bit QAT against the
            quantized view ``deploy(target="multibit", cell_bits=...)``
            serves (batched mode; composes with a noise-only
            ``noise_sim``).
          noise_sampler: where the noise fields come from (default: the
            seeded generators of ``imcsim.device.draw``).
          init_seed: the numpy seed of ``init_method="random"`` (default:
            drawn from ``gen``; the reference's is
            ``sum(key_data(key)) % 2**31``).

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
                    gen, feats, labels, method=init_method, h=h, q=q,
                    init_seed=init_seed)
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
        noise_base = None
        if noise_sim is not None:
            from repro_torch.imcsim import device as device_lib
            noise_base = (device_lib.device_instance_key(noise_sim)
                          if noise_mode == "fixed" else (noise_sim.seed,))
        for ep in range(start_epoch + 1, epochs + 1):
            if mode == "sequential":
                state = qail.qail_epoch_sequential(state, self.am_cfg, h, q,
                                                   labels)
                miss = float("nan")
            else:
                nkey = None
                if noise_base is not None:
                    nkey = (noise_base if noise_mode == "fixed"
                            else noise_base + (ep,))
                state, n_miss = qail.qail_epoch_scan(
                    state, self.am_cfg, hb, qb, yb, mask,
                    refresh_every=refresh_every, use_kernel=use_kernel,
                    sim=noise_sim, noise_key=nkey, noise_mode=noise_mode,
                    cell_bits=cell_bits, sampler=noise_sampler)
                miss = float(n_miss) / n  # the one host sync this epoch
            rec = {"epoch": ep, "train_miss": miss}
            if eval_q is not None:
                rec["eval_acc"] = qail.evaluate(state, eval_q, eval_labels)
            curve.append(rec)
            if ep % ckpt_every == 0 or ep == epochs:
                _save(ep, state)
        model = dataclasses.replace(model, am_state=state)
        return model, {"init": init_hist, "curve": curve}

    def fit_sharded(self, gen: GenLike, feats, labels, *, mesh=None,
                    epochs: Optional[int] = None,
                    init_method: str = "clustering",
                    refresh_every: int = 1) -> Tuple["MemhdModel", Dict]:
        """Data-parallel fit over a device list (``core.distributed``).

        Encode, initialize, then every prebatched minibatch is cut into one
        row shard per mesh entry; each shard computes its Eq.-(6) delta
        (``qail.qail_batch_delta``: the ``qail_update`` kernel on a GPU) and
        the shards' bfloat16 deltas are summed into the float AM, one host
        sync per epoch. ``mesh``: devices, one shard each, repeats allowed
        (default: every visible GPU for a model on the GPU, the model's
        device otherwise). The batch rounds up to a multiple of the shard
        count. Returns (model, {"init": ..., "curve": ...}).
        """
        from repro_torch.core import distributed
        from repro_torch.deploy.sharded import serving_mesh
        if mesh is None:
            mesh = (None if self.device.type == "cuda" else (self.device,))
        mesh = serving_mesh(mesh)
        epochs = self.am_cfg.epochs if epochs is None else epochs
        labels = self._on_device(labels)

        h = self.encode(feats)
        q = encoding.binarize_query(h)
        model, init_hist = self.initialize_am(
            gen, feats, labels, method=init_method, h=h, q=q)

        n, k = h.shape[0], len(mesh)
        bs = -(-self.am_cfg.batch_size // k) * k
        hb, qb, yb, mask = qail.prebatch(h, q, labels, bs)
        state, curve = distributed.fit_sharded_epochs(
            mesh, model.am_state, self.am_cfg, hb, qb, yb, mask,
            epochs=epochs, refresh_every=refresh_every, n_samples=n)
        state = {key: v.to(self.device) for key, v in state.items()}
        model = dataclasses.replace(model, am_state=state)
        return model, {"init": init_hist, "curve": curve}

    # -- class-incremental growth ---------------------------------------------
    def grow_classes(self, feats, labels, *, centroids_per_class: int = 1,
                     h: Optional[torch.Tensor] = None) -> "MemhdModel":
        """Append never-seen classes to the AM: (C, D) -> (C + k·n, D).

        Classes beyond ``am_cfg.classes`` get fresh centroids: the
        per-class mean of their encoded samples (split into
        ``centroids_per_class`` chunks), rescaled to the mean norm of the
        existing float centroids, without touching the existing ones.
        The new classes must be contiguous from ``am_cfg.classes``. Grow
        BEFORE folding feedback that carries the new labels: QAIL's
        Eq.-(5) target masks on centroid ownership. ``h`` reuses an
        existing ``encode(feats)``. Raises if no label exceeds the current
        classes.

        The means and rescale run in numpy float32 on the host, as the
        reference's do; the mean norm of the float AM is summed in another
        order than the reference's, so the new rows agree with its rows
        within float32 rounding of that one scale.
        """
        old_k = self.am_cfg.classes
        yn = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
              else np.asarray(labels)).astype(np.int64)
        new_classes = sorted(int(c) for c in np.unique(yn) if c >= old_k)
        if not new_classes:
            raise ValueError(
                f"no labels beyond the current {old_k} classes")
        if new_classes != list(range(old_k, old_k + len(new_classes))):
            raise ValueError(
                f"appended classes must be contiguous from {old_k}, "
                f"got {new_classes}")
        if centroids_per_class < 1:
            raise ValueError("centroids_per_class must be >= 1")
        if h is None:
            h = self.encode(feats)
        hn = h.detach().cpu().numpy().astype(np.float32)

        fp = self.am_state["fp"]
        owners = self.am_state["centroid_class"]
        fp_np = fp.detach().cpu().numpy()
        scale = float(np.mean(np.linalg.norm(fp_np, axis=-1)))
        rows, row_owners = [], []
        for c in new_classes:
            members = hn[yn == c]
            if members.shape[0] == 0:
                raise ValueError(f"class {c} has no samples to seed from")
            for part in np.array_split(members, centroids_per_class):
                m = (part if part.shape[0] else members).mean(axis=0)
                if scale > 0:
                    m = m * (scale / max(float(np.linalg.norm(m)), 1e-8))
                rows.append(m)
                row_owners.append(c)

        fp_new = torch.cat([fp, torch.as_tensor(
            np.stack(rows).astype(np.float32), device=fp.device)])
        owners_new = torch.cat([owners, torch.as_tensor(
            row_owners, dtype=torch.int32, device=owners.device)])
        cfg = dataclasses.replace(
            self.am_cfg, columns=self.am_cfg.columns + len(rows),
            classes=old_k + len(new_classes))
        state = am_lib.make_am_state(fp_new, owners_new, cfg.threshold)
        return MemhdModel(self.enc_params, state, self.enc_cfg, cfg)

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

        * ``"packed"`` (the default) — the (Dp, C) uint8 1-bit residence,
          ``mode="popcount"`` or ``"unpack"``;
        * ``"unpacked"`` — the ±1 float32 (C, D) residence searched by
          the ``am_search`` kernel;
        * ``"imc"`` — a simulated analog device (``repro_torch.imcsim``):
          the binary AM burned in with the faults and conductance
          variation of ``sim`` (an ``ImcSimConfig``, seeded), queries
          through the tiled analog search + ADC (``am_search_imc``); an
          ideal ``sim`` equals the digital artifacts bit for bit;
        * ``"multibit"`` — the float shadow at ``cell_bits`` (2..8) bits
          per cell in bit planes, searched by ``am_search_multibit``
          (an optional ``sim`` sets the array, ADC and drift);
        * ``"hierarchical"`` — the coarse-to-fine top-k artifact
          (``groups=``, ``shortlist=``): ``am_shortlist`` over G packed
          super-centroids, then ``am_search_sparse`` over the shortlisted
          clusters' tiles; ``predict_topk``. S = G equals the flat scan.

        ``packed=False`` is the legacy spelling of ``target="unpacked"``.
        ``sim=`` with a digital target raises."""
        from repro_torch.deploy import registry
        if target in (None, "digital"):
            target = "unpacked" if packed is False else "packed"
        elif packed is not None:
            raise ValueError(
                "packed= is the legacy digital switch; use "
                "target='packed' / target='unpacked' instead")
        if sim is not None and target not in ("imc", "multibit"):
            raise ValueError(
                "sim= is only meaningful with target='imc' or 'multibit'")
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
        """Closed-form IMC mapping of this model's geometry
        (``core.imc.memhd_pipeline``; default 128x128 arrays)."""
        from repro_torch.core.imc import memhd_pipeline
        from repro_torch.core.types import ImcArrayConfig
        return memhd_pipeline(self.enc_cfg.features, self.am_cfg.dim,
                              self.am_cfg.columns, arr or ImcArrayConfig())
