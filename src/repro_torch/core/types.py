"""Core configuration types for the MEMHD framework.

Everything here is a plain frozen dataclass: configs are data, passed
explicitly, hashable, and serializable into checkpoints' manifests. The
classes are field-for-field copies of ``repro.core.types`` (held equal by
tests/test_torch_core.py); the port keeps its own copy because importing
``repro.core.types`` runs ``repro/core/__init__.py``, which imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Configuration of the hypervector encoding module (EM).

    Attributes:
      kind: ``"projection"`` (binary random projection, MVM-based — the
        encoder MEMHD and BasicHDC use; maps directly onto IMC arrays) or
        ``"id_level"`` (ID x Level composition used by SearcHD / QuantHD /
        LeHDC in the paper's baseline table).
      features: input feature count ``f``.
      dim: hypervector dimensionality ``D``.
      levels: number of quantization levels ``L`` for id_level encoding.
      binarize_query: if True the encoded hypervector is binarized
        (sign) before associative search — the binary-HDC setting.
    """

    kind: str = "projection"
    features: int = 784
    dim: int = 1024
    levels: int = 256
    binarize_query: bool = True

    def __post_init__(self):
        if self.kind not in ("projection", "id_level"):
            raise ValueError(f"unknown encoder kind: {self.kind!r}")
        if self.features <= 0 or self.dim <= 0:
            raise ValueError("features and dim must be positive")

    @property
    def memory_bits(self) -> int:
        """Bits of EM storage, following Table I of the paper."""
        if self.kind == "projection":
            return self.features * self.dim  # f x D binary matrix
        return (self.features + self.levels) * self.dim  # (f+L) x D


@dataclasses.dataclass(frozen=True)
class MemhdConfig:
    """Configuration of the MEMHD multi-centroid associative memory.

    ``dim`` x ``columns`` is the paper's D x C geometry: D matches the IMC
    array's row count, C its column count (so ``128x128`` means D=128 and
    C=128 total centroids across all classes).

    Attributes:
      dim: hypervector dimension D (AM row count).
      columns: total number of centroids C (AM column count), summed over
        classes — full utilization means every column holds a centroid.
      classes: number of classes k.
      init_ratio: the paper's R — fraction of columns filled by the
        initial class-wise clustering; the remaining C(1-R) columns are
        allocated by the confusion-matrix driven loop (§III-A2).
      kmeans_iters: Lloyd iterations per (re-)clustering call.
      epochs: quantization-aware iterative-learning epochs (§III-C).
      lr: iterative-learning rate alpha (paper: 0.01-0.1).
      update_with: which representation of the sample updates the float
        AM in Eq. (6): "encoded" (pre-binarization H, default) or
        "binary" (H^b).
      normalize: per-centroid normalization applied to the float AM after
        each epoch, before re-binarization (§III-C step 4). "l2" or "none".
      threshold: binarization threshold for the AM: "mean" (paper,
        §III-B: global mean of the float AM) or "per_centroid".
      batch_size: minibatch size for the batched QAIL variant (the
        sequential variant follows the paper sample-by-sample).
      seed: PRNG seed.
    """

    dim: int = 128
    columns: int = 128
    classes: int = 10
    init_ratio: float = 0.8
    kmeans_iters: int = 25
    epochs: int = 100
    lr: float = 0.02
    update_with: str = "encoded"
    normalize: str = "l2"
    threshold: str = "mean"
    batch_size: int = 256
    seed: int = 0

    def __post_init__(self):
        if self.columns < self.classes:
            raise ValueError(
                f"C={self.columns} must be >= k={self.classes}: every class "
                "needs at least one centroid"
            )
        if not (0.0 < self.init_ratio <= 1.0):
            raise ValueError("init_ratio R must be in (0, 1]")
        if self.update_with not in ("encoded", "binary"):
            raise ValueError(f"bad update_with: {self.update_with!r}")
        if self.normalize not in ("l2", "none"):
            raise ValueError(f"bad normalize: {self.normalize!r}")
        if self.threshold not in ("mean", "per_centroid"):
            raise ValueError(f"bad threshold: {self.threshold!r}")

    @property
    def am_memory_bits(self) -> int:
        """Binary AM footprint in bits (C x D), per Table I."""
        return self.columns * self.dim

    def am_memory_bits_at(self, cell_bits: int = 1) -> int:
        """Table-I AM bits generalized to multi-level cells: C x D cells
        at ``cell_bits`` bits each (``cell_bits=1`` is the paper's
        binary accounting; the ``target="multibit"`` deployment stores
        2-8 bits per cell)."""
        if cell_bits < 1:
            raise ValueError(f"cell_bits={cell_bits} < 1")
        return self.columns * self.dim * cell_bits

    @property
    def initial_clusters_per_class(self) -> int:
        """n = max(1, floor(C*R / k)) — §III-A1."""
        return max(1, int(self.columns * self.init_ratio) // self.classes)


@dataclasses.dataclass(frozen=True)
class ImcArrayConfig:
    """Geometry + energy constants of one IMC array tile.

    The paper evaluates 128x128 SRAM arrays with NeuroSim-derived
    read/write energies [19], [20]. The *relative* cost model (cycles =
    sequential tile passes, energy ~ tiles processed) is what Table II and
    Fig. 7 report.

    Attributes:
      rows / cols: array dimensions (the paper uses 128x128).
      e_read_pass_pj: energy of one full-array MVM (read) pass, pJ.
      e_write_cell_fj: per-cell write energy, fJ (used by the training-
        time write accounting; inference is read-only).
      t_cycle_ns: latency of one array pass, ns.
    """

    rows: int = 128
    cols: int = 128
    e_read_pass_pj: float = 36.7
    e_write_cell_fj: float = 0.58
    t_cycle_ns: float = 5.2

    def __post_init__(self):
        if self.rows <= 0 or self.cols <= 0:
            raise ValueError("array dims must be positive")


@dataclasses.dataclass(frozen=True)
class ImcSimConfig:
    """Device-fidelity knobs for simulated analog AM search (imcsim).

    The digital kernels compute the associative search exactly; a real
    IMC deployment computes it through per-array analog partial sums,
    finite-resolution ADCs and imperfect cells. This config bundles the
    fidelity model that ``kernels/am_search_imc.py`` and
    ``repro.imcsim`` simulate. It is a frozen, hashable dataclass.

    Attributes:
      arr: geometry of one physical array tile (rows x cols); the
        simulated search is tiled into exactly these blocks and the
        kernel grid equals ``imc.map_memhd(...).cycles``.
      adc_bits: ADC resolution b. Each tile's analog partial sum is
        quantized by a symmetric mid-tread quantizer with step
        ``2*clip / 2**b`` (2^b + 1 codes) before digital accumulation.
        With the default power-of-two clip the step is a power of two,
        so integer-valued bipolar partial sums are reproduced exactly
        whenever ``2*clip / 2**b <= 1`` — e.g. any b >= 8 at the default
        128-row array, which is what makes the >=16-bit parity contract
        bit-exact.
      adc_clip: ADC full-scale range; partial sums are clipped to
        [-clip, +clip] before quantization. None means ``arr.rows`` (the
        physical maximum of a bipolar tile partial sum).
      noise_sigma: std-dev of i.i.d. Gaussian conductance variation
        added to each stored cell (bipolar domain, cell magnitude 1).
      fault_p0 / fault_p1: per-cell stuck-at fault probabilities. A
        stuck-at-0 cell reads bit 0 (bipolar -1), stuck-at-1 reads bit 1
        (bipolar +1), regardless of the written value.
      drift_sigma: std-dev of the per-tile additive readout offset
        (one Gaussian offset per (row-tile, col-tile) array, applied to
        the tile's partial sum before the ADC).
      seed: PRNG seed for the device perturbations; the same config
        always deploys the same simulated device instance.
    """

    arr: ImcArrayConfig = ImcArrayConfig()
    adc_bits: int = 16
    adc_clip: Optional[float] = None
    noise_sigma: float = 0.0
    fault_p0: float = 0.0
    fault_p1: float = 0.0
    drift_sigma: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.adc_bits < 1:
            raise ValueError("adc_bits must be >= 1")
        if self.adc_clip is not None and self.adc_clip <= 0:
            raise ValueError("adc_clip must be positive")
        for name in ("noise_sigma", "drift_sigma"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0")
        if not (0.0 <= self.fault_p0 <= 1.0 and 0.0 <= self.fault_p1 <= 1.0
                and self.fault_p0 + self.fault_p1 <= 1.0):
            raise ValueError(
                "fault_p0/fault_p1 must be probabilities with p0 + p1 <= 1")

    @property
    def clip(self) -> float:
        """Effective ADC full-scale range."""
        return float(self.arr.rows if self.adc_clip is None else
                     self.adc_clip)

    @property
    def adc_step(self) -> float:
        """Quantization step of the mid-tread ADC."""
        return 2.0 * self.clip / (2 ** self.adc_bits)

    @property
    def ideal(self) -> bool:
        """True when every perturbation is off (exact-parity regime
        additionally needs ``adc_step <= 1``, see ``adc_bits``)."""
        return (self.noise_sigma == 0.0 and self.drift_sigma == 0.0
                and self.fault_p0 == 0.0 and self.fault_p1 == 0.0)


@dataclasses.dataclass(frozen=True)
class BaselineConfig:
    """Configuration for the binary-HDC baselines of Table I.

    Attributes:
      kind: "basic" | "quanthd" | "lehdc" | "searchd".
      dim: hypervector dimensionality D.
      classes: k.
      n_models: SearcHD's N (vector-quantization factor; paper fixes 64).
      epochs: iterative epochs (quanthd / lehdc).
      lr: learning rate.
      seed: PRNG seed.
    """

    kind: str = "basic"
    dim: int = 10240
    classes: int = 10
    n_models: int = 64
    epochs: int = 30
    lr: float = 0.05
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("basic", "quanthd", "lehdc", "searchd"):
            raise ValueError(f"unknown baseline kind: {self.kind!r}")

    def am_memory_bits(self) -> int:
        """Binary AM bits, per Table I."""
        if self.kind == "searchd":
            return self.classes * self.dim * self.n_models
        return self.classes * self.dim


# Dataset shape registry (true dataset geometries; the synthetic
# generators in repro_torch.data.hdc are faithful to these).
@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    features: int
    classes: int
    train_per_class: int
    test_per_class: int
    # Number of latent intra-class modes the synthetic generator uses;
    # chosen to mirror each dataset's known intra-class diversity.
    latent_modes: int = 4


DATASETS = {
    "mnist": DatasetSpec("mnist", features=784, classes=10,
                         train_per_class=6000, test_per_class=1000,
                         latent_modes=6),
    "fmnist": DatasetSpec("fmnist", features=784, classes=10,
                          train_per_class=6000, test_per_class=1000,
                          latent_modes=6),
    "isolet": DatasetSpec("isolet", features=617, classes=26,
                          train_per_class=240, test_per_class=60,
                          latent_modes=3),
}


def dataset_spec(name: str) -> DatasetSpec:
    try:
        return DATASETS[name]
    except KeyError:
        raise KeyError(
            f"unknown dataset {name!r}; known: {sorted(DATASETS)}"
        ) from None
