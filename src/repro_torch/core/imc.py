"""IMC array mapping & cost model (cycles / arrays / utilization / energy).

A verbatim copy of ``repro.core.imc`` (pure Python, no framework), so
that the port imports nothing of the JAX package; the kernel names below
are the reference's, whose counterparts live in ``repro_torch.kernels``.

This module reproduces, in closed form, the accounting of Table II and
Fig. 7 of the paper and exposes it as a first-class cost model that other
layers consume:

* the Pallas ``am_search`` kernel asserts its grid size equals
  ``cycles(...)`` from this model (hardware model == kernel geometry);
* the energy benchmark (Fig. 7) evaluates ``energy(...)`` ratios;
* ``launch/dryrun.py`` reports MEMHD array occupancy next to the LM
  rooflines;
* the device-fidelity simulator (``repro.imcsim`` +
  ``kernels/am_search_imc.py``) tiles its simulated analog search into
  exactly this model's (A x A) blocks, so ``assert_consistent_sim``
  holds for any array geometry.

Mapping semantics (validated against every entry of Table II):

An MVM with weight matrix (R rows x C_cols) is tiled onto (A x A) arrays.

* ``basic`` mapping — the weight matrix is tiled directly:
    tiles  = ceil(R/A) * ceil(C_cols/A)
    arrays = tiles                 (weights are resident, one tile each)
    cycles = tiles                 (sequential passes on one physical array)
* ``partitioned`` mapping [9] — the D-dim vector is split into P segments;
  segment matrices sit side-by-side in the column dimension:
    R'      = R / P,  C' = C_cols * P
    arrays  = ceil(R'/A) * ceil(C'/A)
    cycles  = P * ceil(R'/A) * ceil(C_cols/A)   (all segment tiles still
              stream through sequentially — partitioning saves arrays,
              never cycles; exactly the paper's Fig. 1-(b) point)
* ``memhd`` mapping — the AM is (D x C) with D, C chosen to match the
  array, so tiles = ceil(D/A) * ceil(C/A) and (for D=C=A) one-shot search.

Utilization = fraction of mapped-array columns actually used.
Energy      = tiles_processed * e_read_pass (one array MVM pass each) —
              reproducing Fig. 7's "partitioning keeps energy constant,
              MEMHD divides it by the tile count" behaviour.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.types import ImcArrayConfig


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MappingCost:
    """Cost of mapping one MVM stage (EM or AM) onto IMC arrays."""

    rows: int                  # logical weight rows (vector dim fed in)
    cols: int                  # logical weight cols (outputs)
    partitions: int            # P (1 = unpartitioned)
    cycles: int                # sequential passes on a single array
    arrays: int                # physical arrays to hold all weights
    used_columns: int          # occupied columns across mapped arrays
    total_columns: int         # available columns across mapped arrays

    @property
    def utilization(self) -> float:
        return self.used_columns / self.total_columns

    def energy_pj(self, arr: ImcArrayConfig) -> float:
        """Inference (read) energy: one pass per sequential tile."""
        return self.cycles * arr.e_read_pass_pj

    def latency_ns(self, arr: ImcArrayConfig) -> float:
        return self.cycles * arr.t_cycle_ns


def map_basic(rows: int, cols: int, arr: ImcArrayConfig) -> MappingCost:
    """Direct tiling (the paper's 'Basic' mapping, Fig. 1-(a))."""
    rb = _ceil_div(rows, arr.rows)
    cb = _ceil_div(cols, arr.cols)
    tiles = rb * cb
    return MappingCost(
        rows=rows, cols=cols, partitions=1,
        cycles=tiles, arrays=tiles,
        used_columns=cols * rb,
        total_columns=cb * arr.cols * rb,
    )


def map_partitioned(rows: int, cols: int, partitions: int,
                    arr: ImcArrayConfig) -> MappingCost:
    """Partitioning [9] (Fig. 1-(b)): D split into P segments packed
    across columns. rows must be divisible by partitions."""
    if rows % partitions:
        raise ValueError(f"rows={rows} not divisible by P={partitions}")
    seg_rows = rows // partitions
    packed_cols = cols * partitions
    rb = _ceil_div(seg_rows, arr.rows)
    cb = _ceil_div(packed_cols, arr.cols)
    arrays = rb * cb
    # Every segment's row-tiles still stream sequentially (partial sums
    # for different segments cannot be fused in-array):
    cycles = partitions * rb * _ceil_div(cols, arr.cols)
    return MappingCost(
        rows=rows, cols=cols, partitions=partitions,
        cycles=cycles, arrays=arrays,
        used_columns=packed_cols * rb,
        total_columns=cb * arr.cols * rb,
    )


def map_memhd(dim: int, columns: int, arr: ImcArrayConfig) -> MappingCost:
    """MEMHD mapping: the (D x C) multi-centroid AM tiles the array
    exactly; full utilization by construction when D,C are multiples of
    the array size (the configs enforce that)."""
    return map_basic(dim, columns, arr)


def encoder_cost(features: int, dim: int, arr: ImcArrayConfig,
                 ) -> MappingCost:
    """EM mapping cost: the (f x D) binary projection MVM."""
    return map_basic(features, dim, arr)


@dataclasses.dataclass(frozen=True)
class PipelineCost:
    """EM + AM inference cost for one input sample."""

    em: MappingCost
    am: MappingCost

    @property
    def total_cycles(self) -> int:
        return self.em.cycles + self.am.cycles

    @property
    def total_arrays(self) -> int:
        return self.em.arrays + self.am.arrays

    def energy_pj(self, arr: ImcArrayConfig) -> float:
        return self.em.energy_pj(arr) + self.am.energy_pj(arr)


def memhd_pipeline(features: int, dim: int, columns: int,
                   arr: ImcArrayConfig) -> PipelineCost:
    return PipelineCost(em=encoder_cost(features, dim, arr),
                        am=map_memhd(dim, columns, arr))


def basic_pipeline(features: int, dim: int, classes: int,
                   arr: ImcArrayConfig) -> PipelineCost:
    return PipelineCost(em=encoder_cost(features, dim, arr),
                        am=map_basic(dim, classes, arr))


def partitioned_pipeline(features: int, dim: int, classes: int,
                         partitions: int, arr: ImcArrayConfig,
                         ) -> PipelineCost:
    return PipelineCost(em=encoder_cost(features, dim, arr),
                        am=map_partitioned(dim, classes, partitions, arr))


def table2(arr: ImcArrayConfig | None = None) -> Dict[str, Dict]:
    """Recompute Table II of the paper for the 128x128 array.

    Returns a nested dict keyed by dataset group and mapping method with
    cycles/arrays/utilization for EM, AM and totals — asserted verbatim
    against the paper's numbers in tests/test_imc_model.py.
    """
    arr = arr or ImcArrayConfig()
    out: Dict[str, Dict] = {}

    # (a) MNIST / FMNIST: f=784, baseline D=10240, k=10; MEMHD 128x128.
    out["mnist_fmnist"] = {
        "basic": basic_pipeline(784, 10240, 10, arr),
        "partition_p5": partitioned_pipeline(784, 10240, 10, 5, arr),
        "partition_p10": partitioned_pipeline(784, 10240, 10, 10, arr),
        "memhd": memhd_pipeline(784, 128, 128, arr),
    }
    # (b) ISOLET: f=617, baseline D=10240, k=26; MEMHD 512x128.
    out["isolet"] = {
        "basic": basic_pipeline(617, 10240, 26, arr),
        "partition_p2": partitioned_pipeline(617, 10240, 26, 2, arr),
        "partition_p4": partitioned_pipeline(617, 10240, 26, 4, arr),
        "memhd": memhd_pipeline(617, 512, 128, arr),
    }
    return out


def am_energy_ratio(dim: int, cols: int, baseline_dim: int,
                    baseline_cols: int, arr: ImcArrayConfig | None = None,
                    ) -> float:
    """Fig.-7 style normalized AM energy ratio baseline/MEMHD."""
    arr = arr or ImcArrayConfig()
    e_base = map_basic(baseline_dim, baseline_cols, arr).energy_pj(arr)
    e_memhd = map_memhd(dim, cols, arr).energy_pj(arr)
    return e_base / e_memhd


def mxu_grid(dim: int, columns: int, tile: int = 128) -> tuple:
    """The TPU analogue: Pallas grid for the (D x C) AM search kernel.

    One grid step == one 128x128 MXU block pass == one IMC array cycle;
    kernels/am_search.py asserts ``math.prod(mxu_grid(...)) ==
    map_memhd(...).cycles`` so the silicon model and the kernel stay
    consistent.
    """
    return (_ceil_div(dim, tile), _ceil_div(columns, tile))


def assert_consistent(dim: int, columns: int, arr: ImcArrayConfig | None = None):
    arr = arr or ImcArrayConfig()
    grid = mxu_grid(dim, columns, arr.rows)
    cycles = map_memhd(dim, columns, arr).cycles
    if math.prod(grid) != cycles:
        raise AssertionError(
            f"kernel grid {grid} inconsistent with IMC cycle model {cycles}")


def sim_grid(dim: int, columns: int, arr: ImcArrayConfig | None = None,
             ) -> tuple:
    """(row-tiles, col-tiles) the device-fidelity kernel iterates: the
    tile decomposition of the (D x C) AM onto (rows x cols) arrays.
    Unlike ``mxu_grid`` this honors non-square array geometry."""
    arr = arr or ImcArrayConfig()
    return (_ceil_div(dim, arr.rows), _ceil_div(columns, arr.cols))


def assert_consistent_sim(dim: int, columns: int,
                          arr: ImcArrayConfig | None = None):
    """Hardware model == simulated-kernel geometry, any array shape."""
    arr = arr or ImcArrayConfig()
    grid = sim_grid(dim, columns, arr)
    cycles = map_memhd(dim, columns, arr).cycles
    if math.prod(grid) != cycles:
        raise AssertionError(
            f"imcsim kernel grid {grid} inconsistent with IMC cycle "
            f"model {cycles}")
