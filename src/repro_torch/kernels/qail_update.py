"""Fused QAIL minibatch step: sims, Eq.-(4)/(5) targets, Eq.-(6) delta.

Port of ``repro.kernels.qail_update`` (``csrc/qail_update.cu``). One
call computes, for a minibatch of binarized queries, the similarity
against the binary AM, the push-away (Eq. 4, global argmax) and
pull-toward (Eq. 5, argmax within the true class) targets, the miss
mask, and the (C, D) float-AM increment

    delta = W^T @ upd,  W[i] = lr*mis_i*(onehot(true_i) - onehot(pred_i)),

without float atomics: every delta element is summed by one thread in
row order, so two runs agree bit for bit. ``am_t`` may be any strided
(D, C) view (the transposed view of the (C, D) binary AM needs no copy).
``block_b`` picks the query tile of the similarity pass; the result does
not depend on it.

A CPU tensor goes through the plain version (``ref.qail_update_delta``);
a CUDA tensor through the kernel or raises. ``qail_update.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BN = 64  # AM columns per similarity tile (csrc/sims_argmax.cuh)
BLOCK_B_CHOICES = (16, 32, 64)  # queries per similarity tile
DEFAULT_BLOCK_B = 32


def _check(q, upd, am_t, centroid_class, labels, mask, block_b):
    if block_b not in BLOCK_B_CHOICES:
        raise ValueError(f"block_b={block_b} not in {BLOCK_B_CHOICES}")
    b, d = q.shape
    d2, c = am_t.shape
    if d != d2 or upd.shape != q.shape:
        raise ValueError(f"shapes differ: q {tuple(q.shape)}, upd "
                         f"{tuple(upd.shape)}, am_t {tuple(am_t.shape)}")
    if centroid_class.shape != (c,) or labels.shape != (b,) \
            or mask.shape != (b,):
        raise ValueError("centroid_class must be (C,), labels and mask (B,)")
    if c == 0 or d == 0:
        raise ValueError("the AM has no columns or no dims")
    devices = {t.device for t in (q, upd, am_t, centroid_class, labels,
                                  mask)}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {devices}")


def qail_update_targets(q: torch.Tensor, upd: torch.Tensor,
                        am_t: torch.Tensor, centroid_class: torch.Tensor,
                        labels: torch.Tensor, mask: torch.Tensor, *,
                        lr: float, block_b: int = DEFAULT_BLOCK_B):
    """``qail_update`` that also returns its targets:
    (delta, n_miss, pred_t, true_t, mis), with pred_t / true_t (B,)
    int64 on the CPU and int32 from the kernel, mis (B,) float32."""
    _check(q, upd, am_t, centroid_class, labels, mask, block_b)
    if q.device.type == "cpu":
        pred_t, true_t, mis = ref.qail_targets(q, am_t, centroid_class,
                                               labels, mask)
        delta, n_miss = ref.qail_delta(upd, pred_t, true_t, mis, lr,
                                       am_t.shape[1])
        return delta, n_miss, pred_t, true_t, mis
    if q.device.type != "cuda":
        raise ValueError(f"qail_update: unsupported device {q.device}")
    b, d = q.shape
    c = am_t.shape[1]
    _build.check_operand(q, "q", torch.float32, 2)
    _build.check_operand(upd, "upd", torch.float32, 2)
    _build.check_operand(am_t, "am_t", torch.float32, 2, contiguous=False)
    _build.check_operand(centroid_class, "centroid_class", torch.int32, 1)
    _build.check_operand(labels, "labels", torch.int32, 1)
    _build.check_operand(mask, "mask", torch.float32, 1)
    dev = q.device
    n_ct = -(-c // BN)
    part_s = torch.empty((2, b, n_ct), dtype=torch.float32, device=dev)
    part_i = torch.empty((2, b, n_ct), dtype=torch.int32, device=dev)
    pred_t = torch.empty((b,), dtype=torch.int32, device=dev)
    true_t = torch.empty((b,), dtype=torch.int32, device=dev)
    mis = torch.empty((b,), dtype=torch.float32, device=dev)
    delta = torch.empty((c, d), dtype=torch.float32, device=dev)
    n_miss = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        err = lib.qail_update_launch(
            q.data_ptr(), upd.data_ptr(), am_t.data_ptr(), am_t.stride(0),
            am_t.stride(1), centroid_class.data_ptr(), labels.data_ptr(),
            mask.data_ptr(), float(lr), part_s.data_ptr(),
            part_i.data_ptr(), pred_t.data_ptr(), true_t.data_ptr(),
            mis.data_ptr(), delta.data_ptr(), n_miss.data_ptr(), b, d, c,
            block_b, _build.stream_of(q))
    _build.check(err, "qail_update")
    qail_update.launches += 1
    return delta, n_miss, pred_t, true_t, mis


def qail_update(q: torch.Tensor, upd: torch.Tensor, am_t: torch.Tensor,
                centroid_class: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, *, lr: float,
                block_b: int = DEFAULT_BLOCK_B,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused QAIL inner step for one minibatch.

    Args:
      q: (B, D) float32 binarized queries H^b.
      upd: (B, D) float32 Eq.-(6) update payload (encoded H or H^b).
      am_t: (D, C) float32 transposed binary AM, any strides.
      centroid_class: (C,) int32 centroid ownership.
      labels: (B,) int32 true labels (-1 marks padded rows).
      mask: (B,) float32 {0, 1} sample validity.
      lr: the iterative-learning rate alpha.
      block_b: queries per similarity tile (one of ``BLOCK_B_CHOICES``).

    Returns:
      (delta, n_miss): (C, D) float32 Eq.-(6) AM increment and the
      float32 scalar count of mispredicted (masked) samples.
    """
    delta, n_miss, _, _, _ = qail_update_targets(
        q, upd, am_t, centroid_class, labels, mask, lr=lr, block_b=block_b)
    return delta, n_miss


qail_update.launches = 0
