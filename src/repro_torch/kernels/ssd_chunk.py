"""One Mamba-2 SSD chunk: wrapper of the ``ssd_chunk`` CUDA kernel.

Port of ``repro.kernels.ssd_chunk`` (``csrc/ssd_chunk.cu``): for every
(batch row, head), cum = cumsum(da), the causal decay exp(cum_i - cum_j),
y = (C Bᵀ ∘ decay)(x·dt) + (C ∘ e^cum) S and the state leaving the chunk
S' = e^{cum_Q} S + (B ∘ e^{cum_Q - cum})ᵀ (x·dt), all in float32. The
chunk-to-chunk recurrence stays in the caller (``models.layers.
ssd_forward``), as in the reference. The products run on the tensor cores
at float32 accuracy: a float32 operand enters as two or three terms (TF32
hi and lo, or three bf16 terms), as many as the product needs against its
other operand (bf16 inputs are exact in one term).

``launch_plan`` is the kernel's grid and shared memory, computed here so
that the CPU tests can check it and handed to the launcher, which refuses
a plan other than its own: every (batch row, head) gets one block per
64-row tile of y and one per 32 rows of the new state.

A CPU tensor goes through the plain version (``ref.ssd_chunk``); a CUDA
tensor through the kernel or raises. ``ssd_chunk.launches`` counts
kernel launches.

``SsdChunk`` is the differentiable route: its forward is ``ssd_chunk``
(the kernel on a CUDA tensor), its backward recomputes the chunk through
``ref.ssd_chunk`` under autograd and returns that VJP for every input.
The reference differentiates its chunk body as plain jnp (remat'd), and
its Pallas kernel has no VJP, so there is no backward kernel to port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MAX_DIM = 128  # largest d_state N and head_dim P the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK_SMEM = 232448  # shared memory one block may opt into (H100)
# csrc/ssd_chunk.cu: y rows per block and keys per tile, rows of the new
# state per state block, B tiles in flight.
TILE = 64
STATE_ROWS = 32
STAGES = 2


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def col_tiles(p: int) -> int:
    """n8 tiles over P of the instance that takes head dim ``p``."""
    return next(c for c in (2, 4, 8, 16) if p <= 8 * c)


def smem_bytes(q: int, n: int, p: int, dtype: torch.dtype) -> int:
    """Shared memory of one block (``Geom`` in ``csrc/ssd_chunk.cu``):
    cum, dt and the per-key exponentials (Q padded to 64, float32); the C
    tile; an area for a float32 x tile as TF32 (hi, lo) pairs (4 KB per n8
    tile over P), the entering state and the key halves' sums; x tiles
    (two of bfloat16, read in place, or one raw float32 tile) and two B
    tiles. Rows are padded to 4 mod 32 floats or 8 mod 32 bf16."""
    es = torch.tensor([], dtype=dtype).element_size()
    pad = 4 if es == 4 else 8
    sn, sp, ss = _up(n, 32) + pad, _up(p, 32) + pad, _up(p, 32) + 8
    x_stages = 1 if es == 4 else 2
    xf = max(2048 * col_tiles(p) * (2 if es == 4 else 1), _up(n, 8) * ss * 4)
    return (3 * _up(q, TILE) * 4 + TILE * sn * es + xf
            + TILE * (x_stages * sp + STAGES * sn) * es)


def launch_plan(b: int, q: int, h: int, n: int, p: int,
                dtype: torch.dtype) -> dict:
    """Blocks per (batch row, head): ``state_blocks`` slices of the new
    state, then ``y_blocks`` row tiles of y, heaviest first; the grid, the
    shared memory and the n8 tiles over P of the instance chosen."""
    y_blocks, state_blocks = -(-q // TILE), -(-n // STATE_ROWS)
    return {"y_blocks": y_blocks, "state_blocks": state_blocks,
            "blocks": (y_blocks + state_blocks) * b * h,
            "smem": smem_bytes(q, n, p, dtype), "col_tiles": col_tiles(p)}


def unit_work(unit: int, q: int, n: int, p: int) -> dict:
    """What block ``unit`` of a (batch row, head) computes: rows of the new
    state (every column), or y rows and the key tiles they walk (the
    kernel's ``is_y``, ``it`` and ``n0`` in ``csrc/ssd_chunk.cu``)."""
    y_blocks, state_blocks = -(-q // TILE), -(-n // STATE_ROWS)
    if unit < state_blocks:
        n0 = unit * STATE_ROWS
        return {"state_rows": range(n0, min(n, n0 + STATE_ROWS)),
                "state_cols": range(p), "key_tiles": range(y_blocks)}
    tile = y_blocks - 1 - (unit - state_blocks)
    return {"y_rows": range(TILE * tile, min(q, TILE * tile + TILE)),
            "key_tiles": range(tile + 1)}


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
    plan = launch_plan(bsz, q, h, n, p, x.dtype)
    if plan["smem"] > BLOCK_SMEM:
        raise ValueError(f"ssd_chunk: Q={q} needs {plan['smem']} bytes of "
                         f"shared memory per block, over {BLOCK_SMEM}")
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
            bsz, q, h, n, p, *strides, DTYPES[x.dtype], plan["y_blocks"],
            plan["state_blocks"], plan["col_tiles"], plan["smem"],
            _build.stream_of(x))
    _build.check(err, "ssd_chunk")
    ssd_chunk.launches += 1
    return y, s_new


ssd_chunk.launches = 0


class SsdChunk(torch.autograd.Function):
    """``ssd_chunk`` with a gradient: the forward launches the kernel
    (counted by ``ssd_chunk.launches``), the backward is the VJP of the
    plain version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, b, c, dt, da, state):
        ctx.save_for_backward(x, b, c, dt, da, state)
        return ssd_chunk(x, b, c, dt, da, state)

    @staticmethod
    def backward(ctx, gy, gs):
        need = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            outs = ref.ssd_chunk(*inputs)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(outs, wanted, (gy, gs),
                                             allow_unused=True))
        return tuple(next(grads) if n else None for n in need)
