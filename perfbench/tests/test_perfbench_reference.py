"""The plain reference agrees with the program on the CPU, route by route:
a whole run of each cell at a small size checks every served row."""
import numpy as np
import pytest
import torch

from perfbench import harness, reference

CELLS = ("mnist1024-packed-bulk", "huge100k-hier-top5",
         "huge100k-flat-top1", "mnist1024-imc-bulk")


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_on_the_cpu_is_correct(tiny_root, cell):
    out = harness.run(cell, 2 ** 33 + 7, 0.3, False, root=tiny_root,
                      device="cpu", strict=False)
    assert out["correct"], out["checks"]
    assert out["checks"]["rows_wrong"]["value"] == 0
    assert out["info"]["checked_rows"] > 0
    assert set(out["metrics"]) == {"rows_per_s", "setup_s"}


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 3 * 2 ** -11)])
    # Exactly representable; a tie to even down; a tie to even up.
    assert reference.round_tf32(x).tolist() == [
        1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -9)]


def test_top_by_key_orders_by_similarity_then_lower_id():
    sims = torch.tensor([[3.0, 5.0, 5.0, -1.0, 5.0]])
    valid = torch.tensor([[True, True, True, True, False]])
    idx, best = reference.top_by_key(sims, valid, 4, 8)
    assert idx.tolist() == [[1, 2, 0, 3]]
    assert best.tolist() == [[5.0, 5.0, 3.0, -1.0]]
    idx, best = reference.top_by_key(sims, valid, 6, 8)
    assert idx.tolist()[0][4:] == [-1, -1]
    assert best[0, 5].item() == reference.NEG


def test_the_clustering_copy_matches_the_deploy():
    """The frozen clustering gives the deploy's supers and members."""
    from perfbench.reference import hierarchical as ref_h
    from repro_torch.deploy import hierarchical as hier
    gen = torch.Generator().manual_seed(5)
    protos = torch.randint(0, 2, (12, 64), generator=gen).float() * 2 - 1
    am = protos[torch.randint(0, 12, (700,), generator=gen)]
    am = torch.where(torch.rand(am.shape, generator=gen) < 0.1, -am, am)
    supers, assign = ref_h.cluster(9, am, 16, 8, 256)
    want_supers, want_assign = hier.cluster_am(9, am, 16, n_iters=8,
                                               sample=256, device="cpu")
    assert torch.equal(supers, want_supers)
    assert np.array_equal(assign.numpy(), want_assign.numpy())
