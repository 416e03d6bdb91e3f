"""Transformer / SSM layers of the LM stack, as functions over dicts of
tensors.

Port of the part of ``repro.models.layers`` that the hybrid and SSM
stacks reach (hymba-1.5b, mamba2-130m, and the dense GQA configs):
RMSNorm, RoPE, GQA attention (chunked online-softmax ``attention_full``,
sliding-window ``attention_local``, and the decode step through the
``flash_decode`` kernel), the dense FFN, and Mamba-2 SSD (the chunked
``ssd_forward`` through the ``ssd_chunk`` kernel, the O(1) decode step).

Each ``init_*`` draws from an explicit ``torch.Generator`` with the
reference's shapes, dtypes and distributions and returns the params only
(the reference also returns logical sharding axes, which a single device
has no use for; its ``shard_act`` annotations are no-ops here and are
dropped). ``use_kernel=False`` runs the kernels' plain versions.

Not ported yet, each raising ``NotImplementedError``: MLA, MoE,
cross-attention, the int8 KV cache and the sequence-parallel decode.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import AttnSpec, FfnSpec, SsmSpec

Params = Dict[str, torch.Tensor]
NEG_INF = float("-inf")


def deferred(what: str, item: str = "queue 1 item 17") -> None:
    """Raise for a part of the LM stack the port does not have yet."""
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32."""
    return F.rms_norm(x.float(), x.shape[-1:], 1.0 + scale.float(),
                      eps).to(x.dtype)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


def _dense_init(gen: torch.Generator, shape, dtype, device,
                in_axis: int = 0) -> torch.Tensor:
    std = 1.0 / math.sqrt(shape[in_axis])
    return (torch.randn(shape, generator=gen, device=device)
            * std).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, Dh); positions: (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
             theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rope`` of q and k in one pass (one angle table for both)."""
    qk = rope(torch.cat([q, k], dim=2), positions, theta)
    return qk[:, :, :q.shape[2]], qk[:, :, q.shape[2]:]


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
             device) -> Params:
    if spec.kind != "gqa":
        deferred("MLA attention")
    h, kv, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    p = {"wq": _dense_init(gen, (d_model, h, dh), dtype, device),
         "wk": _dense_init(gen, (d_model, kv, dh), dtype, device),
         "wv": _dense_init(gen, (d_model, kv, dh), dtype, device),
         "wo": _dense_init(gen, (h, dh, d_model), dtype, device)}
    if spec.qkv_bias:
        p["bq"] = _zeros((h, dh), dtype, device)
        p["bk"] = _zeros((kv, dh), dtype, device)
        p["bv"] = _zeros((kv, dh), dtype, device)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matmul."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _project(p: Params, spec: AttnSpec, x: torch.Tensor,
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = (_heads(x, p[w]) for w in ("wq", "wk", "wv"))
    if spec.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def _qkv(p: Params, spec: AttnSpec, x: torch.Tensor,
         positions: torch.Tensor,
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project(p, spec, x)
    return (*_rope_qk(q, k, positions, spec.rope_theta), v)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_offset: int = 0, softcap: Optional[float] = None,
                   chunk: int = 1024) -> torch.Tensor:
    """Chunked causal attention with online softmax.

    q: (B, Sq, H, Dh); k, v: (B, Skv, H, Dh) (kv already head-repeated).
    ``q_offset``: absolute position of q[0] relative to k[0]; the causal
    mask is (q_offset + i) >= j. The last chunk is the ragged remainder
    (the reference pads it with keys it masks: the same sums).
    """
    b, sq, h, dh = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    chunk = min(chunk, skv)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dv), dtype=torch.float32, device=q.device)
    for start in range(0, skv, chunk):
        kb, vb = k[:, start:start + chunk], v[:, start:start + chunk]
        k_pos = start + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb) * scale
        s = _softcap(s, softcap)
        s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1).float())
        # Guard fully-masked rows (exp(-inf - -inf)).
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vb.dtype), vb).float()
        m = m_new
    out = acc / l[..., None].clamp_min(1e-20)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, *, softcap: Optional[float] = None,
                    block: int = 512) -> torch.Tensor:
    """Sliding-window causal attention (prefill path).

    Query block i attends keys [i*block - window, i*block + block): a
    static-size neighbourhood, so the work is O(S * (window + block)).
    A query attends the last ``window`` keys including itself, as the
    decode ring buffer does.
    """
    b, s, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    block = min(block, s)
    n_blocks = -(-s // block)
    pad_q = n_blocks * block - s
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    # KV padded on the left by `window` so every block's neighbourhood is
    # in range, and on the right to the padded q length.
    kp = F.pad(k, (0, 0, 0, 0, window, pad_q))
    vp = F.pad(v, (0, 0, 0, 0, window, pad_q))
    span = window + block
    outs = []
    for i in range(n_blocks):
        qb = qp[:, i * block:(i + 1) * block]
        kb = kp[:, i * block:i * block + span]
        vb = vp[:, i * block:i * block + span]
        sc = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        sc = _softcap(sc, softcap)
        q_pos = i * block + torch.arange(block, device=q.device)[:, None]
        k_pos = (i * block - window
                 + torch.arange(span, device=q.device)[None, :])
        mask = ((q_pos >= k_pos) & (q_pos - k_pos < window) & (k_pos >= 0)
                & (q_pos < s) & (k_pos < s))
        sc = sc.masked_fill(~mask, NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.exp(sc - m)
        p = torch.where(torch.isfinite(sc), p, 0.0)
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype), vb)
        denom = p.sum(dim=-1).transpose(1, 2)[..., None]
        outs.append(o / denom.clamp_min(1e-20).to(o.dtype))
    return torch.cat(outs, dim=1)[:, :s]


def gqa_forward(p: Params, spec: AttnSpec, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Prefill GQA attention over hidden states x: (B, S, D)."""
    if spec.kind != "gqa":
        deferred("MLA attention")
    q, k, v = _qkv(p, spec, x, positions)
    groups = spec.n_heads // spec.n_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if spec.window is not None and x.shape[1] > spec.window:
        out = attention_local(q, k, v, spec.window,
                              softcap=spec.logit_softcap)
    else:
        out = attention_full(q, k, v, softcap=spec.logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def gqa_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], *, use_kernel: bool = True,
               seq_parallel: bool = False,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, D); cache: {k, v, len}.

    cache["k"/"v"]: (B, S_cache, KV, Dh), a ring buffer when the layer is
    windowed (S_cache == window), linear otherwise. The new k/v are
    written into the cache tensors in place (the reference returns new
    arrays); slots [0, valid) are always the filled ones and attention
    does not depend on the keys' order, so the ring needs no unrolling.
    The attention is ``ops.flash_decode`` over the un-repeated KV heads.
    """
    if seq_parallel:
        deferred("seq_parallel_decode")
    if spec.logit_softcap is not None:
        deferred("logit_softcap in decode (flash_decode has no softcap)")
    pos = cache["len"]  # (B,) absolute position of the new token
    q, k, v = _project(p, spec, x)
    q, k = _rope_qk(q, k, pos[:, None], spec.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    s_cache = k_cache.shape[1]
    slot = pos % s_cache if spec.window is not None else pos
    valid = torch.clamp_max(pos + 1, s_cache)
    idx = (torch.arange(x.shape[0], device=x.device), slot.long())
    k_cache.index_put_(idx, k[:, 0])
    v_cache.index_put_(idx, v[:, 0])
    out = ops.flash_decode(q[:, 0], k_cache, v_cache, valid,
                           use_kernel=use_kernel)
    y = (out.flatten(1) @ p["wo"].flatten(0, 1))[:, None]
    return y, {"k": k_cache, "v": v_cache, "len": pos + 1}


def init_gqa_cache(spec: AttnSpec, batch: int, max_len: int, dtype,
                   device, quant: bool = False) -> Dict[str, torch.Tensor]:
    if quant:
        deferred("kv_cache_quant (the int8 KV cache)")
    s = min(max_len, spec.window) if spec.window is not None else max_len
    shape = (batch, s, spec.n_kv_heads, spec.head_dim)
    return {"k": _zeros(shape, dtype, device),
            "v": _zeros(shape, dtype, device),
            "len": _zeros((batch,), torch.int32, device)}


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------

def _act(name: str, gate: torch.Tensor,
         up: Optional[torch.Tensor]) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation.
    if name == "silu_glu":
        return F.silu(gate) * up
    if name == "gelu_glu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "gelu":
        return F.gelu(gate, approximate="tanh")
    if name == "squared_relu":
        r = F.relu(gate)
        return r * r
    raise ValueError(name)


def init_dense_ffn(gen: torch.Generator, d_model: int, spec: FfnSpec,
                   dtype, device) -> Params:
    if spec.kind != "dense":
        deferred("MoE FFN")
    p = {"w_in": _dense_init(gen, (d_model, spec.d_ff), dtype, device),
         "w_out": _dense_init(gen, (spec.d_ff, d_model), dtype, device)}
    if spec.activation.endswith("_glu"):
        p["w_up"] = _dense_init(gen, (d_model, spec.d_ff), dtype, device)
    return p


def dense_ffn(p: Params, spec: FfnSpec, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["w_in"]
    up = x @ p["w_up"] if "w_up" in p else None
    return _act(spec.activation, gate, up) @ p["w_out"]


# ---------------------------------------------------------------------------
# Mamba-2 (SSD)
# ---------------------------------------------------------------------------

def init_ssm(gen: torch.Generator, d_model: int, spec: SsmSpec, dtype,
             device) -> Params:
    d_in = spec.expand * d_model
    n_heads = d_in // spec.head_dim
    conv_dim = d_in + 2 * spec.n_groups * spec.d_state
    # in_proj emits [z (gate), x, B, C, dt].
    d_proj = 2 * d_in + 2 * spec.n_groups * spec.d_state + n_heads
    w_in = _dense_init(gen, (d_model, d_proj), dtype, device)
    conv_w = _dense_init(gen, (spec.conv_width, conv_dim), dtype, device)
    lo, hi = math.log(spec.dt_min), math.log(spec.dt_max)
    u = torch.rand((n_heads,), generator=gen, device=device) * (hi - lo) + lo
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": _zeros((conv_dim,), dtype, device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, n_heads,
                                          device=device)).to(dtype),
        "d_skip": torch.ones((n_heads,), dtype=dtype, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "gate_norm": _zeros((d_in,), dtype, device),
        "w_out": _dense_init(gen, (d_in, d_model), dtype, device),
    }


def _ssm_split(spec: SsmSpec, d_model: int, proj: torch.Tensor):
    d_in = spec.expand * d_model
    gn = spec.n_groups * spec.d_state
    n_heads = d_in // spec.head_dim
    return (proj[..., :d_in], proj[..., d_in: 2 * d_in + 2 * gn],
            proj[..., -n_heads:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width W. xbc: (B, S, C)."""
    width, s = w.shape[0], xbc.shape[1]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(xp[:, i: i + s] * w[i] for i in range(width))
    return F.silu(out + b)


def _split_heads(spec: SsmSpec, d_in: int, xbc: torch.Tensor):
    """(x (.., H, P), B (.., H, N), C (.., H, N)) from the conv output,
    B and C repeated from their groups to the heads."""
    g, n, ph = spec.n_groups, spec.d_state, spec.head_dim
    n_heads = d_in // ph
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_in].reshape(*lead, n_heads, ph)
    bmat = xbc[..., d_in: d_in + g * n].reshape(*lead, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(*lead, g, n)
    hpg = n_heads // g
    return (xs, torch.repeat_interleave(bmat, hpg, dim=-2),
            torch.repeat_interleave(cmat, hpg, dim=-2))


def ssd_forward(p: Params, spec: SsmSpec, d_model: int, x: torch.Tensor, *,
                use_kernel: bool = True) -> torch.Tensor:
    """Chunked SSD (Mamba-2). x: (B, S, D) -> (B, S, D).

    The chunk-to-chunk recurrence stays here: one ``ops.ssd_chunk`` per
    chunk of Q = min(chunk, S) steps, the last chunk zero-padded (dt = da
    = 0 on the pad: it adds nothing to y or the state).
    """
    b, s, _ = x.shape
    d_in = spec.expand * d_model
    n_heads = d_in // spec.head_dim
    n, ph = spec.d_state, spec.head_dim

    proj = x @ p["w_in"]
    z, xbc, dt = _ssm_split(spec, d_model, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = _split_heads(spec, d_in, xbc)
    xs = xs.contiguous()

    dt = F.softplus(dt.float() + p["dt_bias"].float())       # (B,S,H)
    a = -torch.exp(p["a_log"].float())                       # (H,)
    da = dt * a                                              # log-decay

    q = min(spec.chunk, s)
    n_chunks = -(-s // q)
    pad = n_chunks * q - s

    def pad_t(t):
        return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

    xs_p, b_p, c_p, dt_p, da_p = (pad_t(t) for t in (xs, bmat, cmat, dt,
                                                      da))
    state = torch.zeros((b, n_heads, n, ph), dtype=torch.float32,
                        device=x.device)
    ys = []
    for i in range(n_chunks):
        cut = slice(i * q, (i + 1) * q)
        y_c, state = ops.ssd_chunk(xs_p[:, cut], b_p[:, cut], c_p[:, cut],
                                   dt_p[:, cut], da_p[:, cut], state,
                                   use_kernel=use_kernel)
        ys.append(y_c)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y.to(xs.dtype) + xs * p["d_skip"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(b, s, d_in)
    y = rms_norm(y * F.silu(z), p["gate_norm"])
    return (y @ p["w_out"]).to(x.dtype)


def ssd_decode(p: Params, spec: SsmSpec, d_model: int, x: torch.Tensor,
               cache: Dict[str, torch.Tensor],
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) per-token SSD decode. x: (B, 1, D).

    cache: {"state": (B,H,N,P), "conv": (B,W-1,convdim), "len": (B,)}.
    """
    b = x.shape[0]
    d_in = spec.expand * d_model
    proj = x @ p["w_in"]  # (B,1,dproj)
    z, xbc, dt = _ssm_split(spec, d_model, proj)
    # Causal conv against the rolling window.
    window = torch.cat([cache["conv"], xbc], dim=1)  # (B,W,conv)
    conv_out = (window * p["conv_w"]).sum(dim=1) + p["conv_b"]
    xs, bmat, cmat = _split_heads(spec, d_in, F.silu(conv_out))

    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B,H)
    a = -torch.exp(p["a_log"].float())
    gate = torch.exp(dt1 * a)  # (B,H)
    xdt = xs.float() * dt1[..., None]                          # (B,H,P)
    state32 = (cache["state"].float() * gate[..., None, None]
               + bmat.float()[..., None] * xdt[..., None, :])
    y = (cmat.float()[..., None, :] @ state32)[..., 0, :]      # (B,H,P)
    y = y.to(xs.dtype) + xs * p["d_skip"].to(xs.dtype)[None, :, None]
    y = rms_norm(y.reshape(b, 1, d_in) * F.silu(z), p["gate_norm"])
    return (y @ p["w_out"]).to(x.dtype), {
        "state": state32.to(cache["state"].dtype), "conv": window[:, 1:],
        "len": cache["len"] + 1}


def init_ssm_cache(spec: SsmSpec, d_model: int, batch: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    d_in = spec.expand * d_model
    n_heads = d_in // spec.head_dim
    conv_dim = d_in + 2 * spec.n_groups * spec.d_state
    return {"state": _zeros((batch, n_heads, spec.d_state, spec.head_dim),
                            dtype, device),
            "conv": _zeros((batch, spec.conv_width - 1, conv_dim), dtype,
                           device),
            "len": _zeros((batch,), torch.int32, device)}
