"""Each kernel's count at one shape, worked by hand, and the trace
arithmetic the readers use."""
import pytest

from perfbench import trace
from perfbench.counts import (am_search_imc, am_search_packed,
                              am_search_sparse, am_shortlist, encode_pack)

PEAKS = {"fp32_flop_per_s": 67e12, "b1_op_per_s": 15832e12,
         "hbm_byte_per_s": 3.35e12}


def test_encode_pack_at_the_cells_batch():
    # 2 * 4096 * 784 * 1024; float32 feats 4096 * 784 * 4, projection
    # 784 * 1024 * 4, packed queries 4096 * 128.
    assert encode_pack.ops_bytes(4096, 784, 1024) == (
        6_576_668_672, 12_845_056 + 3_211_264 + 524_288)


def test_am_search_packed_over_100k_columns():
    # 2 * 4096 * 1024 * 100000; queries 4096 * 128, AM 128 * 100000,
    # id + similarity 8 a row.
    assert am_search_packed.ops_bytes(4096, 1024, 100_000) == (
        838_860_800_000, 524_288 + 12_800_000 + 32_768)


def test_am_shortlist():
    # 2 * 4096 * 448 * 1024; queries, supers 128 * 448, 8 * 4096 * 8 out.
    assert am_shortlist.ops_bytes(4096, 1024, 448, 8) == (
        3_758_096_384, 524_288 + 57_344 + 262_144)


def test_am_search_sparse_counts_the_members_searched():
    # 1,000 (query, member) pairs at 2 * 1024; 300 touched columns of
    # 128 + 4 bytes, queries, (4096, 8) int32 shortlist, 448 starts and
    # counts, 4096 * 5 slots of 8 bytes.
    assert am_search_sparse.ops_bytes(4096, 1024, 448, 8, 5, 1000, 300) == (
        2_048_000, 39_600 + 524_288 + 131_072 + 3_584 + 163_840)


def test_am_search_imc():
    # 2 * 4096 * 1024 * 1024; float32 queries and cells, 8 x 8 offsets.
    assert am_search_imc.ops_bytes(4096, 1024, 1024, 128, 128) == (
        8_589_934_592, 16_777_216 + 4_194_304 + 256 + 32_768)


def test_bound_takes_the_larger_term():
    ops, nbytes = encode_pack.ops_bytes(4096, 784, 1024)
    assert trace.bound(ops, nbytes, 67e12, PEAKS) == pytest.approx(
        6_576_668_672 / 67e12)
    assert trace.bound(1, 3.35e9, 67e12, PEAKS) == pytest.approx(1e-3)


def profile():
    # Device ops at [0, 1), [0.5, 2) and [3, 4) in a window [0, 5); host
    # spans: dispatch over [2, 2.6], wait over [2.6, 3.2].
    ops = [(0.0, 1.0, "void k_a<1>(int)"), (0.5, 2.0, "k_b"),
           (3.0, 4.0, "void k_a<2>(int)")]
    spans = [(2.0, 2.6, "dispatch"), (2.6, 3.2, "wait")]
    return trace.Profile((0.0, 5.0), ops, spans)


def test_busy_time_is_the_union_of_the_ops():
    p = profile()
    assert p.busy() == [[0.0, 2.0], [3.0, 4.0]]
    assert p.busy_s == pytest.approx(3.0)
    assert p.device_time(("k_a",)) == pytest.approx(2.0)


def test_idle_gaps_are_named_by_the_open_span():
    # Gap [2, 3): midpoint 2.5 in "dispatch"; gap [4, 5): no span.
    assert profile().idle_gaps() == [["dispatch", 1.0], ["loop", 1.0]]


def test_device_ops_sum_by_name_without_arguments():
    assert profile().device_ops() == [["k_b", 1.5], ["k_a<1>", 1.0],
                                      ["k_a<2>", 1.0]]


class _Counts:
    NAMES = ("k_a",)

    @staticmethod
    def bound_s(ctx):
        return 0.5


def test_roofline_is_the_bound_over_the_device_time():
    ctx = trace.Context(root=None, config={}, route={}, batch_rows=1,
                        peaks=PEAKS, profile=profile(), calls=2, rows=2,
                        works=[], dispatch_s=0.0, dispatch_calls=0)
    assert trace.roofline(ctx, _Counts) == pytest.approx(25.0)


def test_no_roofline_where_the_kernel_did_not_run():
    ctx = trace.Context(root=None, config={}, route={}, batch_rows=1,
                        peaks=PEAKS, profile=trace.Profile((0, 1), [], []),
                        calls=2, rows=2, works=[], dispatch_s=0.0,
                        dispatch_calls=0)
    assert trace.roofline(ctx, _Counts) is None
