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

The kernel picks its similarity route on the device, per call: when q
and the AM view are integers in [-127, 127] (±1 queries against the
binary AM or multi-bit QAT codes) the sims run exactly on int8 tensor
cores; otherwise (a noise-perturbed float view) in fp32 FMAs. Both give
the plain version's targets. ``route_counts()`` reads how many calls took
each route (one device sync); ``reset_routes()`` zeroes them.

A CPU tensor goes through the plain version (``ref.qail_update_delta``);
a CUDA tensor through the kernel or raises. ``qail_update.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

BN = 64  # AM columns per similarity tile (csrc/sims_argmax.cuh)
BLOCK_B_CHOICES = (16, 32, 64)  # queries per similarity tile
DEFAULT_BLOCK_B = 16
# csrc/qail_update.cu: int8 bytes of k per ring stage (D pads to it), the
# convert pass's square tile.
K_SLAB = 128
CONV_TILE = 64
ROUTES = _build.RouteCounts.NAMES
_ROUTES = _build.RouteCounts()


def _align256(n: int) -> int:
    return -(-n // 256) * 256


def sims_smem(block_b: int) -> int:
    """Dynamic shared bytes of a sims-pass block of ``block_b`` queries
    (``sims_smem`` in ``csrc/qail_update.cu``): the largest of the int8
    ring (4 stages of the block's query and AM rows, 128 bytes of k each),
    the float sims tile and the fp32 route's k stage."""
    ring = 4 * (block_b + BN) * K_SLAB
    tile = 4 * block_b * (BN + 1)
    stage = 4 * 16 * (block_b + 1 + BN + 1)
    return max(ring, tile, stage)


def plan(b: int, d: int, c: int, block_b: int) -> dict:
    """The kernel's tiles and the byte offsets of its scratch (``Plan`` in
    ``csrc/qail_update.cu``, which refuses a call whose size differs):
    the int8 copies of q (bp, dp) and of the AM (cp, dp), one flag word
    per convert tile, one counter per query tile, and the (2, B, n_ct)
    partials (float, then int32)."""
    n_ct, n_rt = -(-c // BN), -(-b // block_b)
    dp = -(-d // K_SLAB) * K_SLAB
    bp, cp = n_rt * block_b, n_ct * BN
    kt = dp // CONV_TILE
    n_am_tiles = kt * (cp // CONV_TILE)
    n_conv = n_am_tiles + kt * -(-bp // CONV_TILE)
    sizes = {"q8": bp * dp, "am8": cp * dp, "flags": 4 * n_conv,
             "counters": 4 * n_rt, "part_s": 4 * 2 * b * n_ct,
             "part_i": 4 * 2 * b * n_ct}
    offsets, at = {}, 0
    for name, size in sizes.items():
        offsets[name] = at
        at += _align256(size)
    return {"n_ct": n_ct, "n_rt": n_rt, "dp": dp, "bp": bp, "cp": cp,
            "n_conv": n_conv, "n_am_tiles": n_am_tiles, "sizes": sizes,
            "offsets": offsets, "scratch_bytes": at}


def routes(device: torch.device) -> torch.Tensor:
    """The (2,) int32 device counter of calls per route on ``device``."""
    return _ROUTES.tensor(device)


def route_counts() -> dict[str, int]:
    """Calls per similarity route since the last reset, over all devices."""
    return _ROUTES.counts()


def reset_routes() -> None:
    _ROUTES.reset()


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
    scratch_bytes = plan(b, d, c, block_b)["scratch_bytes"]
    scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
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
            mask.data_ptr(), float(lr), scratch.data_ptr(), scratch_bytes,
            routes(dev).data_ptr(), pred_t.data_ptr(), true_t.data_ptr(),
            mis.data_ptr(), delta.data_ptr(), n_miss.data_ptr(), b, d, c,
            block_b, _build.stream_of(q))
    _build.check(err, "qail_update")
    qail_update.launches += 1
    counts = qail_update.block_b_launches
    counts[block_b] = counts.get(block_b, 0) + 1
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
qail_update.block_b_launches = {}  # block_b -> launches
