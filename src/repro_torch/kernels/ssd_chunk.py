"""One Mamba-2 SSD chunk: wrapper of the ``ssd_chunk`` CUDA kernel.

Port of ``repro.kernels.ssd_chunk`` (``csrc/ssd_chunk.cu``): for every
(batch row, head), cum = cumsum(da), the causal decay exp(cum_i - cum_j),
y = (C Bᵀ ∘ decay)(x·dt) + (C ∘ e^cum) S and the state leaving the chunk
S' = e^{cum_Q} S + (B ∘ e^{cum_Q - cum})ᵀ (x·dt), all in float32. The
chunk-to-chunk recurrence stays in the caller (``models.layers.
ssd_forward``), as in the reference.

A CPU tensor goes through the plain version (``ref.ssd_chunk``); a CUDA
tensor through the kernel or raises. ``ssd_chunk.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_DIM = 128  # largest d_state N and head_dim P the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _batch_stride(t: torch.Tensor, name: str) -> int:
    """Element stride between batch rows of ``t``, whose rows must each
    be contiguous (a slice of a longer sequence along dim 1 is)."""
    if t.shape[0] > 1 and not t[0].is_contiguous():
        raise ValueError(f"{name}: each batch row must be contiguous")
    if t.shape[0] == 1 and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.stride(0)


def ssd_chunk(x: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              dt: torch.Tensor, da: torch.Tensor, state: torch.Tensor,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk for all (batch, head) pairs.

    Args:
      x: (B, Q, H, P) float32 or bfloat16; any Q >= 1, P <= 128.
      b/c: (B, Q, H, N), x's dtype, N <= 128.
      dt/da: (B, Q, H) float32 (step size and log-decay).
      state: (B, H, N, P) float32 entering the chunk.
      Batch rows may be strided (chunks sliced from a sequence).

    Returns: (y (B, Q, H, P) in x's dtype, new_state (B, H, N, P) f32).
    """
    if x.dim() != 4 or b.dim() != 4 or dt.dim() != 3:
        raise ValueError("ssd_chunk: bad ranks")
    bsz, q, h, p = x.shape
    n = b.shape[-1]
    if (tuple(b.shape) != (bsz, q, h, n) or c.shape != b.shape
            or tuple(dt.shape) != (bsz, q, h) or da.shape != dt.shape
            or tuple(state.shape) != (bsz, h, n, p)):
        raise ValueError(
            f"ssd_chunk: shapes disagree: x {tuple(x.shape)}, b "
            f"{tuple(b.shape)}, c {tuple(c.shape)}, dt {tuple(dt.shape)}, "
            f"da {tuple(da.shape)}, state {tuple(state.shape)}")
    if len({t.device for t in (x, b, c, dt, da, state)}) != 1:
        raise ValueError("ssd_chunk: operands on different devices")
    if x.device.type == "cpu":
        return ref.ssd_chunk(x, b, c, dt, da, state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    for t, name, dtype in ((b, "b", x.dtype), (c, "c", x.dtype),
                           (dt, "dt", torch.float32),
                           (da, "da", torch.float32),
                           (state, "state", torch.float32)):
        _build.check_operand(t, name, dtype, t.dim(), contiguous=False)
    _build.check_operand(state, "state", torch.float32, 4)
    if not (1 <= n <= MAX_DIM and 1 <= p <= MAX_DIM):
        raise ValueError(f"ssd_chunk: N={n}, P={p} outside [1, {MAX_DIM}]")
    strides = [_batch_stride(t, name) for t, name in
               ((x, "x"), (b, "b"), (c, "c"), (dt, "dt"), (da, "da"))]
    y = torch.empty((bsz, q, h, p), dtype=x.dtype, device=x.device)
    s_new = torch.empty((bsz, h, n, p), dtype=torch.float32,
                        device=x.device)
    if bsz * h == 0:
        return y, s_new
    if q == 0:
        return y, s_new.copy_(state)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_chunk_launch(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), dt.data_ptr(),
            da.data_ptr(), state.data_ptr(), y.data_ptr(), s_new.data_ptr(),
            bsz, q, h, n, p, *strides, DTYPES[x.dtype],
            _build.stream_of(x))
    _build.check(err, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, s_new


ssd_chunk.launches = 0
