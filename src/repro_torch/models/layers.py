"""Transformer / SSM layers of the LM stack, as functions over dicts of
tensors.

Port of ``repro.models.layers`` on one device: RMSNorm, RoPE, GQA
attention (chunked online-softmax ``attention_full``, sliding-window
``attention_local``, the decode step through the ``flash_decode`` kernel
with the logit softcap, and the int8 KV cache's decode), MLA (the
materialized prefill and the absorbed decode over the latent cache),
cross-attention, the dense FFN, the top-k MoE FFN (local sort-based
dispatch), and Mamba-2 SSD (the chunked ``ssd_forward`` through the
``ssd_chunk`` kernel, the O(1) decode step). MLA, MoE, cross-attention
and the int8 cache are plain torch, as they are plain ``jnp`` in the
reference. The forward paths are differentiable under autograd, the SSD
chunk's kernel route through ``kernels.ssd_chunk.SsdChunk`` (the kernel
forward, the plain version's VJP), which is what the LM train step
differentiates.

Each ``init_*`` draws from an explicit ``torch.Generator`` with the
reference's shapes, dtypes and distributions and returns the params
only; the reference's logical sharding axes come from the matching
``*_axes`` function (``transformer.param_axes`` assembles the tree).
Under ``abstract_init()`` every init allocates ``torch.empty`` on the
meta device and draws nothing (the dry run's shapes). The reference's
``shard_act`` annotations are identities here and are dropped.
``use_kernel=False`` runs the kernels' plain versions.

Under sharding rules (``models.sharding.use_rules``) two paths run over
the rules' mesh, each issuing its collectives through
``distributed.collectives``: the sequence-parallel decode
(``gqa_decode(seq_parallel=True)``: the cache's sequence dim cut over
"model", one ``flash_decode`` per shard, the partials merged by their
log-sum-exp) and the expert-parallel MoE (``moe_ffn``: tokens cut over
every mesh axis, experts over "model", two all-to-alls).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives
from repro_torch.kernels import ops
from repro_torch.models.config import AttnSpec, FfnSpec, SsmSpec
from repro_torch.models.sharding import batch_axes, current_rules

Params = Dict[str, torch.Tensor]
NEG_INF = float("-inf")
# A leaf of more elements is drawn in float32 slices of its leading axis.
DRAW_ELEMS = 1 << 26


# ---------------------------------------------------------------------------
# Abstract init: the dry run needs the params' shapes and dtypes of
# 340B / 671B models without allocating a byte or drawing a number.
# ---------------------------------------------------------------------------

_abstract = threading.local()
META = torch.device("meta")


@contextlib.contextmanager
def abstract_init():
    """Inside, every ``init_*`` returns ``torch.empty`` on the meta device
    and draws nothing (its generator may be None)."""
    prev = getattr(_abstract, "on", False)
    _abstract.on = True
    try:
        yield
    finally:
        _abstract.on = prev


def is_abstract() -> bool:
    return getattr(_abstract, "on", False)


def _made(make, shape, dtype) -> torch.Tensor:
    """``make()``, or a meta tensor of ``shape`` under ``abstract_init``."""
    if is_abstract():
        return torch.empty(shape, dtype=dtype, device=META)
    return make()


# ---------------------------------------------------------------------------
# Basics
# ---------------------------------------------------------------------------

def _promoted(*operands: torch.Tensor) -> List[torch.Tensor]:
    """The operands cast to their promoted dtype (a no-op where they
    agree)."""
    dt = operands[0].dtype
    for t in operands[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in operands]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under jnp's promotion: mixed float operands (an
    activation against a weight of another dtype, either way round)
    multiply in the promoted dtype, as the reference's ``@`` does; torch's
    ``@`` refuses them. A bfloat16 weight is widened exactly, so the
    product is a float32 product of the same numbers, and its gradient
    comes back in the weight's dtype."""
    a, b = _promoted(a, b)
    return a @ b


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` under jnp's promotion, as ``matmul``."""
    return torch.einsum(eq, *_promoted(*operands))


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.bmm`` under jnp's promotion, as ``matmul``."""
    return torch.bmm(*_promoted(a, b))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in float32, returned in
    x's dtype (a float32 scale keeps bfloat16 x bfloat16)."""
    return F.rms_norm(x.float(), x.shape[-1:], 1.0 + scale.float(),
                      eps).to(x.dtype)


def _zeros(shape, dtype, device) -> torch.Tensor:
    return _made(lambda: torch.zeros(shape, dtype=dtype, device=device),
                 shape, dtype)


def normal(gen: torch.Generator, shape, std: float, dtype,
           device) -> torch.Tensor:
    """N(0, std^2) in ``dtype``. A leaf of more than ``DRAW_ELEMS``
    elements is drawn slice by slice of its leading axis, so a float32
    copy of a large bfloat16 leaf is never whole."""
    if is_abstract():
        return _made(None, shape, dtype)
    n = math.prod(shape)
    if n <= DRAW_ELEMS:
        return (torch.randn(shape, generator=gen, device=device)
                * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_ELEMS // (n // shape[0]))
    for i in range(0, shape[0], rows):
        blk = out[i:i + rows]
        blk.copy_(torch.randn(blk.shape, generator=gen, device=device)
                  * std)
    return out


def _dense_init(gen: torch.Generator, shape, dtype, device,
                in_axis: int = 0) -> torch.Tensor:
    return normal(gen, shape, 1.0 / math.sqrt(shape[in_axis]), dtype,
                  device)


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
# Logical sharding axes of each layer's params: the reference's second
# return value of its ``init_*`` (``models.sharding`` resolves them).
# ---------------------------------------------------------------------------

def gqa_axes(spec: AttnSpec) -> Dict[str, tuple]:
    a = {"wq": ("embed", "heads", "head_dim"),
         "wk": ("embed", "kv_heads", "head_dim"),
         "wv": ("embed", "kv_heads", "head_dim"),
         "wo": ("heads", "head_dim", "embed")}
    if spec.qkv_bias:
        a.update(bq=("heads", "head_dim"), bk=("kv_heads", "head_dim"),
                 bv=("kv_heads", "head_dim"))
    return a


def mla_axes(spec: AttnSpec) -> Dict[str, tuple]:
    if spec.q_lora_rank:
        a = {"wq_a": ("embed", "lora"), "q_norm": ("lora",),
             "wq_b": ("lora", "heads", "head_dim")}
    else:
        a = {"wq": ("embed", "heads", "head_dim")}
    a.update(wkv_a=("embed", "lora"), kv_norm=("lora",),
             wk_b=("lora", "heads", "head_dim"),
             wv_b=("lora", "heads", "head_dim"),
             wo=("heads", "head_dim", "embed"))
    return a


def cross_attn_axes() -> Dict[str, tuple]:
    return {"wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "heads", "head_dim"),
            "wv": ("embed", "heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed")}


def dense_ffn_axes(spec: FfnSpec) -> Dict[str, tuple]:
    a = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if spec.activation.endswith("_glu"):
        a["w_up"] = ("embed", "mlp")
    return a


def moe_ffn_axes(spec: FfnSpec) -> Dict[str, tuple]:
    a = {"router": ("embed", None),
         "w_gate": ("experts", "embed", "expert_mlp"),
         "w_up": ("experts", "embed", "expert_mlp"),
         "w_down": ("experts", "expert_mlp", "embed")}
    if spec.router == "sigmoid":
        a["router_bias"] = (None,)
    if spec.n_shared:
        a.update(ws_gate=("embed", "mlp"), ws_up=("embed", "mlp"),
                 ws_down=("mlp", "embed"))
    return a


def ssm_axes() -> Dict[str, tuple]:
    return {"w_in": ("embed", "ssm_inner"), "conv_w": ("conv", "ssm_inner"),
            "conv_b": ("ssm_inner",), "a_log": (None,), "d_skip": (None,),
            "dt_bias": (None,), "gate_norm": ("ssm_inner",),
            "w_out": ("ssm_inner", "embed")}


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
             device) -> Params:
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
    return matmul(x, w.flatten(1)).unflatten(-1, w.shape[1:])


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
    q, k, v = _qkv(p, spec, x, positions)
    groups = spec.n_heads // spec.n_kv_heads
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if spec.window is not None and x.shape[1] > spec.window:
        out = attention_local(q, k, v, spec.window,
                              softcap=spec.logit_softcap)
    else:
        out = attention_full(q, k, v, softcap=spec.logit_softcap)
    return einsum("bshk,hkd->bsd", out, p["wo"])


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
    The attention is ``ops.flash_decode`` over the un-repeated KV heads,
    with the layer's logit softcap.

    With ``seq_parallel`` and active rules that ``seq_parallel_ok``
    accepts (the reference's conditions) the attention runs
    sequence-parallel (``attention_decode_seqpar``) over a cache of
    per-member blocks: one that ``init_gqa_cache(seq_parallel=True)``
    built under the rules, or that ``seq_shard_cache`` cut from a whole
    one. A whole cache there raises: the path exists so that no member
    holds the whole cache. Otherwise the local path runs.
    """
    pos = cache["len"]  # (B,) absolute position of the new token
    q, k, v = _project(p, spec, x)
    q, k = _rope_qk(q, k, pos[:, None], spec.rope_theta)
    sharded = isinstance(cache["k"], list)
    s_cache = (cache["k"][0].shape[1] * cache["seq_shards"] if sharded
               else cache["k"].shape[1])
    slot = pos % s_cache if spec.window is not None else pos
    valid = torch.clamp_max(pos + 1, s_cache)
    rules = current_rules()
    if seq_parallel and seq_parallel_ok(spec, s_cache, rules):
        if not sharded:
            raise ValueError(
                "the sequence-parallel decode takes a sequence-sharded "
                "cache: build it under the rules (T.init_cache, or "
                "init_gqa_cache(seq_parallel=True)) or cut it with "
                "seq_shard_cache")
        out = attention_decode_seqpar(
            q[:, 0], cache["k"], cache["v"], k[:, 0], v[:, 0], slot, valid,
            rules, softcap=spec.logit_softcap, use_kernel=use_kernel)
        y = matmul(out.flatten(1), p["wo"].flatten(0, 1))[:, None]
        return y, {**cache, "len": pos + 1}
    if sharded:
        raise ValueError("a sequence-sharded cache needs the "
                         "sequence-parallel decode under its rules")
    k_cache, v_cache = cache["k"], cache["v"]
    idx = (torch.arange(x.shape[0], device=x.device), slot.long())
    k_cache.index_put_(idx, k[:, 0])
    v_cache.index_put_(idx, v[:, 0])
    out = ops.flash_decode(q[:, 0], k_cache, v_cache, valid,
                           softcap=spec.logit_softcap,
                           use_kernel=use_kernel)
    y = matmul(out.flatten(1), p["wo"].flatten(0, 1))[:, None]
    return y, {"k": k_cache, "v": v_cache, "len": pos + 1}


def _batch_block(mesh, member: int, b: int) -> Tuple[int, slice]:
    """(block index, rows) of the batch a member holds: B cut over the
    batch axes when they divide it, else the whole batch (block 0)."""
    ba = tuple(a for a in batch_axes(mesh) if a in mesh.axis_names)
    n = mesh.axis_size(ba) if ba else 1
    if n == 1 or b % n:
        return 0, slice(0, b)
    i = mesh.axis_index(member, ba)
    return i, slice(i * (b // n), (i + 1) * (b // n))


def seq_parallel_ok(spec: AttnSpec, s_cache: int, rules) -> bool:
    """The reference's conditions for the sequence-parallel decode
    (``layers.py:438-445``): rules with ``shard_seq``, a "model" axis
    that divides the cache's length, and no window."""
    return (rules is not None and rules.shard_seq
            and "model" in rules.mesh.axis_names
            and s_cache % rules.mesh.shape["model"] == 0
            and spec.window is None)


def seq_blocks(mesh, b: int, s: int) -> List[Tuple[slice, slice]]:
    """(rows, keys) of a whole (B, S, ...) cache that each member holds
    in the sequence-parallel decode, in member order: its rows from
    ``_batch_block``, its keys the contiguous slice of its "model"
    index."""
    s_local = s // mesh.shape["model"]
    out = []
    for i in range(mesh.size):
        off = mesh.axis_index(i, "model") * s_local
        out.append((_batch_block(mesh, i, b)[1],
                    slice(off, off + s_local)))
    return out


def seq_shard_cache(cache: Dict[str, torch.Tensor], rules,
                    ) -> Dict[str, object]:
    """An explicit converter: a whole GQA cache cut for the
    sequence-parallel decode. "k" / "v" become lists with one new
    contiguous (B_local, S / model, KV, Dh) block per mesh member, on its
    device (``seq_blocks``); "len" stays whole; "seq_shards" holds the
    "model" size. The whole cache is not written afterwards. A cache
    built under the rules (``init_gqa_cache(seq_parallel=True)``) is cut
    from the start and never whole."""
    mesh = rules.mesh
    b, s = cache["k"].shape[:2]
    out: Dict[str, object] = {"len": cache["len"],
                              "seq_shards": mesh.shape["model"]}
    for name in ("k", "v"):
        blocks = []
        for (rows, keys), dev in zip(seq_blocks(mesh, b, s),
                                     mesh.member_devices()):
            part = cache[name][rows, keys]
            blocks.append(torch.empty(part.shape, dtype=part.dtype,
                                      device=dev).copy_(part))
        out[name] = blocks
    return out


def seq_gather_cache(cache: Dict[str, object], rules,
                     ) -> Dict[str, torch.Tensor]:
    """The whole cache back from the per-member blocks, on the device of
    "len"."""
    mesh = rules.mesh
    b = cache["len"].shape[0]
    s = cache["k"][0].shape[1] * cache["seq_shards"]
    dev = cache["len"].device
    out = {"len": cache["len"]}
    for name in ("k", "v"):
        first = cache[name][0]
        whole = torch.empty((b, s) + tuple(first.shape[2:]),
                            dtype=first.dtype, device=dev)
        for (rows, keys), block in zip(seq_blocks(mesh, b, s), cache[name]):
            whole[rows, keys] = block.to(dev)
        out[name] = whole
    return out


def attention_decode_seqpar(q: torch.Tensor, k_blocks: List[torch.Tensor],
                            v_blocks: List[torch.Tensor],
                            k_new: torch.Tensor, v_new: torch.Tensor,
                            slot: torch.Tensor, cache_len: torch.Tensor,
                            rules, *, softcap: Optional[float] = None,
                            use_kernel: bool = True) -> torch.Tensor:
    """Sequence-parallel flash decode over a sequence-sharded cache (ref
    ``attention_decode_seqpar``).

    q: (B, H, Dh); k_blocks / v_blocks: ``seq_shard_cache``'s per-member
    blocks; k_new / v_new: (B, KV, Dh) this step's entries; slot: (B,)
    global slot to write; cache_len: (B,) valid entries after the write.
    Each member writes the new entries where it owns ``slot`` and runs
    ``ops.flash_decode(..., return_lse=True)`` over its block with
    ``clamp(cache_len - offset, 0, S_local)`` valid keys (the hand-written
    kernel on a CUDA tensor). The partials merge as the reference's
    three reductions over "model" (``collectives.all_reduce``): the max
    of the LSEs, then the sums of the weights w_r = exp(lse_r - max) and
    of w_r * out_r; out = sum(w out) / sum(w), 0 where every shard is
    empty. Returns (B, H, Dh) in q's dtype on q's device.
    """
    mesh = rules.mesh
    b = q.shape[0]
    s_local = k_blocks[0].shape[1]
    outs, lses, blocks = [], [], []
    for i, dev in enumerate(mesh.member_devices()):
        blk, rows = _batch_block(mesh, i, b)
        off = mesh.axis_index(i, "model") * s_local
        kc, vc = k_blocks[i], v_blocks[i]
        local = slot[rows].to(dev) - off
        own = ((local >= 0) & (local < s_local))[:, None, None]
        idx = (torch.arange(kc.shape[0], device=dev),
               local.clamp(0, s_local - 1).long())
        for c, new in ((kc, k_new), (vc, v_new)):
            c.index_put_(idx, torch.where(own, new[rows].to(dev), c[idx]))
        n_local = (cache_len[rows].to(dev) - off).clamp(0, s_local)
        out, lse = ops.flash_decode(q[rows].to(dev), kc, vc,
                                    n_local.to(torch.int32),
                                    softcap=softcap, use_kernel=use_kernel,
                                    return_lse=True)
        outs.append(out)
        lses.append(lse)
        blocks.append(blk)
    m = collectives.all_reduce(lses, mesh, "model", op="max")
    w = [torch.exp(lse - torch.where(torch.isfinite(mg), mg, 0.0))
         for lse, mg in zip(lses, m)]
    l_sum = collectives.all_reduce(w, mesh, "model")
    acc = collectives.all_reduce([wi[..., None] * o for wi, o in
                                  zip(w, outs)], mesh, "model")
    merged: Dict[int, torch.Tensor] = {}
    for i, blk in enumerate(blocks):
        if blk not in merged:
            merged[blk] = (acc[i] / l_sum[i].clamp_min(1e-20)[..., None]
                           ).to(q.device, q.dtype)
    return torch.cat([merged[k] for k in sorted(merged)], dim=0)


def init_gqa_cache(spec: AttnSpec, batch: int, max_len: int, dtype,
                   device, quant: bool = False, seq_parallel: bool = False,
                   ) -> Dict[str, torch.Tensor]:
    """A zero cache. With ``seq_parallel`` under active rules that
    ``seq_parallel_ok`` accepts, "k" / "v" are allocated directly as the
    sequence-parallel decode's per-member blocks (``seq_blocks``), each
    on its member's device, so the whole cache never exists; "len" lies
    on ``device``."""
    s = min(max_len, spec.window) if spec.window is not None else max_len
    shape = (batch, s, spec.n_kv_heads, spec.head_dim)
    rules = current_rules()
    if seq_parallel and not quant and seq_parallel_ok(spec, s, rules):
        mesh = rules.mesh

        def blocks():
            return [_zeros((rows.stop - rows.start, keys.stop - keys.start)
                           + shape[2:], dtype, dev)
                    for (rows, keys), dev in zip(seq_blocks(mesh, batch, s),
                                                 mesh.member_devices())]
        return {"k": blocks(), "v": blocks(),
                "len": _zeros((batch,), torch.int32, device),
                "seq_shards": mesh.shape["model"]}
    if quant:
        # int8 rows + per-(batch, pos, kv-head) float16 scales: ~1.03
        # bytes an element against 2 for bf16.
        return {"k_q": _zeros(shape, torch.int8, device),
                "v_q": _zeros(shape, torch.int8, device),
                "k_s": _zeros(shape[:3], torch.float16, device),
                "v_s": _zeros(shape[:3], torch.float16, device),
                "len": _zeros((batch,), torch.int32, device)}
    return {"k": _zeros(shape, dtype, device),
            "v": _zeros(shape, dtype, device),
            "len": _zeros((batch,), torch.int32, device)}


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int8 quantization over head_dim."""
    scale = x.abs().amax(dim=-1) / 127.0 + 1e-8  # (..., H)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def gqa_decode_quant(p: Params, spec: AttnSpec, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor],
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against an int8 KV cache (``init_gqa_cache(quant=
    True)``), written in place like ``gqa_decode``'s.

    Exact-algebra dequant, in float32: scores = (q . k_int8) * k_scale
    (the per-row scale factors out of the head_dim dot), and the value
    product applies v_scale to the attention probabilities before the
    int8 P @ V; no dequantized cache is formed. Query heads are grouped
    by their KV head instead of repeating the cache.
    """
    b = x.shape[0]
    pos = cache["len"]
    q, k, v = _project(p, spec, x)
    q, k = _rope_qk(q, k, pos[:, None], spec.rope_theta)
    s_cache = cache["k_q"].shape[1]
    slot = pos % s_cache if spec.window is not None else pos
    idx = (torch.arange(b, device=x.device), slot.long())
    for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
        rows, scale = _quant_rows(new)
        cache[name + "_q"].index_put_(idx, rows)
        cache[name + "_s"].index_put_(idx, scale)

    kv, dh = spec.n_kv_heads, spec.head_dim
    qg = q[:, 0].float().reshape(b, kv, spec.n_heads // kv, dh)
    k_s = cache["k_s"].float().transpose(1, 2)[:, :, None, :]  # (B,KV,1,S)
    v_s = cache["v_s"].float().transpose(1, 2)[:, :, None, :]
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache["k_q"].float()) * k_s
    s = _softcap(s * (1.0 / math.sqrt(dh)), spec.logit_softcap)
    valid = torch.clamp_max(pos + 1, s_cache)
    mask = torch.arange(s_cache, device=x.device)[None, :] < valid[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    pw = torch.softmax(s, dim=-1) * v_s
    out = torch.einsum("bkgs,bskd->bkgd", pw, cache["v_q"].float())
    y = matmul(out.reshape(b, -1).to(x.dtype), p["wo"].flatten(0, 1))[:, None]
    return y, {**cache, "len": pos + 1}


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek V2/V3)
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, d_model: int, spec: AttnSpec, dtype,
             device) -> Params:
    h = spec.n_heads
    qk = spec.qk_nope_dim + spec.qk_rope_dim
    p: Params = {}
    if spec.q_lora_rank:
        p["wq_a"] = _dense_init(gen, (d_model, spec.q_lora_rank), dtype,
                                device)
        p["q_norm"] = _zeros((spec.q_lora_rank,), dtype, device)
        p["wq_b"] = _dense_init(gen, (spec.q_lora_rank, h, qk), dtype,
                                device)
    else:
        p["wq"] = _dense_init(gen, (d_model, h, qk), dtype, device)
    # Joint compressed KV + decoupled rope key.
    p["wkv_a"] = _dense_init(
        gen, (d_model, spec.kv_lora_rank + spec.qk_rope_dim), dtype, device)
    p["kv_norm"] = _zeros((spec.kv_lora_rank,), dtype, device)
    p["wk_b"] = _dense_init(gen, (spec.kv_lora_rank, h, spec.qk_nope_dim),
                            dtype, device)
    p["wv_b"] = _dense_init(gen, (spec.kv_lora_rank, h, spec.v_head_dim),
                            dtype, device)
    p["wo"] = _dense_init(gen, (h, spec.v_head_dim, d_model), dtype, device)
    return p


def _mla_q(p: Params, spec: AttnSpec, x: torch.Tensor,
           positions: torch.Tensor, eps: float,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope))."""
    if spec.q_lora_rank:
        q = _heads(rms_norm(matmul(x, p["wq_a"]), p["q_norm"], eps),
                   p["wq_b"])
    else:
        q = _heads(x, p["wq"])
    q_nope = q[..., :spec.qk_nope_dim]
    q_rope = rope(q[..., spec.qk_nope_dim:], positions, spec.rope_theta)
    return q_nope, q_rope


def _mla_kv(p: Params, spec: AttnSpec, x: torch.Tensor,
            positions: torch.Tensor, eps: float,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The latent (c_kv (B,S,lora), k_rope (B,S,1,rope)) of x."""
    kv = matmul(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., :spec.kv_lora_rank], p["kv_norm"], eps)
    k_rope = rope(kv[..., spec.kv_lora_rank:][:, :, None, :], positions,
                  spec.rope_theta)
    return c_kv, k_rope


def mla_forward(p: Params, spec: AttnSpec, x: torch.Tensor,
                positions: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Prefill MLA: per-head K/V materialized from the latent; the V head
    dim differs from the QK one."""
    q_nope, q_rope = _mla_q(p, spec, x, positions, eps)
    c_kv, k_rope = _mla_kv(p, spec, x, positions, eps)
    k_nope = _heads(c_kv, p["wk_b"])
    v = _heads(c_kv, p["wv_b"])
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:-1],
                                         spec.qk_rope_dim)], dim=-1)
    out = attention_full(torch.cat([q_nope, q_rope], dim=-1), k, v)
    return einsum("bshk,hkd->bsd", out, p["wo"])


def mla_decode(p: Params, spec: AttnSpec, x: torch.Tensor,
               cache: Dict[str, torch.Tensor], eps: float = 1e-5,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-form MLA decode against the latent cache, written in place.

    cache["ckv"]: (B, S, kv_lora); cache["krope"]: (B, S, rope). Scores =
    q_nope W_UK^T c_kv + q_rope k_rope (W_UK absorbed into the query), and
    W_UV is applied after the probabilities: the per-token cache is
    kv_lora + rope values.
    """
    b = x.shape[0]
    pos = cache["len"]
    q_nope, q_rope = _mla_q(p, spec, x, pos[:, None], eps)
    c_new, kr_new = _mla_kv(p, spec, x, pos[:, None], eps)
    idx = (torch.arange(b, device=x.device), pos.long())
    ckv, krope = cache["ckv"], cache["krope"]
    ckv.index_put_(idx, c_new[:, 0])
    krope.index_put_(idx, kr_new[:, 0, 0])

    q_abs = einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
    scale = 1.0 / math.sqrt(spec.qk_nope_dim + spec.qk_rope_dim)
    s = (torch.einsum("bshr,btr->bhst", q_abs, ckv)
         + torch.einsum("bshk,btk->bhst", q_rope, krope)) * scale
    valid = (torch.arange(ckv.shape[1], device=x.device)[None, :]
             <= pos[:, None])
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    pw = torch.softmax(s.float(), dim=-1).to(x.dtype)
    ctx = torch.einsum("bhst,btr->bshr", pw, ckv)
    out = einsum("bshr,rhk->bshk", ctx, p["wv_b"])
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return y, {"ckv": ckv, "krope": krope, "len": pos + 1}


def init_mla_cache(spec: AttnSpec, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {"ckv": _zeros((batch, max_len, spec.kv_lora_rank), dtype,
                          device),
            "krope": _zeros((batch, max_len, spec.qk_rope_dim), dtype,
                            device),
            "len": _zeros((batch,), torch.int32, device)}


# ---------------------------------------------------------------------------
# Cross-attention (musicgen conditioning)
# ---------------------------------------------------------------------------

def init_cross_attn(gen: torch.Generator, d_model: int, spec: AttnSpec,
                    dtype, device) -> Params:
    h, dh = spec.n_heads, spec.head_dim
    return {"wq": _dense_init(gen, (d_model, h, dh), dtype, device),
            "wk": _dense_init(gen, (d_model, h, dh), dtype, device),
            "wv": _dense_init(gen, (d_model, h, dh), dtype, device),
            "wo": _dense_init(gen, (h, dh, d_model), dtype, device)}


def cross_attn_forward(p: Params, spec: AttnSpec, x: torch.Tensor,
                       cond: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) attends over cond: (B, T, D); no mask, no RoPE."""
    q, k, v = _heads(x, p["wq"]), _heads(cond, p["wk"]), _heads(cond,
                                                              p["wv"])
    s = torch.einsum("bshk,bthk->bhst", q, k) / math.sqrt(spec.head_dim)
    pw = torch.softmax(s.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bhst,bthk->bshk", pw, v)
    return einsum("bshk,hkd->bsd", out, p["wo"])


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
    p = {"w_in": _dense_init(gen, (d_model, spec.d_ff), dtype, device),
         "w_out": _dense_init(gen, (spec.d_ff, d_model), dtype, device)}
    if spec.activation.endswith("_glu"):
        p["w_up"] = _dense_init(gen, (d_model, spec.d_ff), dtype, device)
    return p


def dense_ffn(p: Params, spec: FfnSpec, x: torch.Tensor) -> torch.Tensor:
    gate = matmul(x, p["w_in"])
    up = matmul(x, p["w_up"]) if "w_up" in p else None
    return matmul(_act(spec.activation, gate, up), p["w_out"])


def init_moe_ffn(gen: torch.Generator, d_model: int, spec: FfnSpec, dtype,
                 device) -> Params:
    """Routed experts (stacked on a leading E axis), the float32 router
    (and the sigmoid router's float32 selection bias), shared experts."""
    e, f = spec.n_experts, spec.d_ff_expert
    p: Params = {
        "router": _dense_init(gen, (d_model, e), torch.float32, device),
        # The reference's draw: std 1 / sqrt(E) (its fan-in axis is 0).
        "w_gate": _dense_init(gen, (e, d_model, f), dtype, device),
        "w_up": _dense_init(gen, (e, d_model, f), dtype, device),
        "w_down": _dense_init(gen, (e, f, d_model), dtype, device),
    }
    if spec.router == "sigmoid":
        p["router_bias"] = _zeros((e,), torch.float32, device)
    if spec.n_shared:
        fs = spec.n_shared * f
        p["ws_gate"] = _dense_init(gen, (d_model, fs), dtype, device)
        p["ws_up"] = _dense_init(gen, (d_model, fs), dtype, device)
        p["ws_down"] = _dense_init(gen, (fs, d_model), dtype, device)
    return p


def top_k_stable(x: torch.Tensor, k: int,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lower index (a stable descending sort; ``torch.topk`` does not order
    ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, spec: FfnSpec,
           router_bias: Optional[torch.Tensor],
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores, top_w, top_i) for either router: the sigmoid router
    chooses on scores + bias and weights by the scores."""
    if spec.router == "sigmoid":
        scores = torch.sigmoid(logits)
        sel = scores + router_bias if router_bias is not None else scores
        top_i = top_k_stable(sel, spec.top_k)[1]
        top_w = torch.gather(scores, 1, top_i)
    else:
        scores = torch.softmax(logits, dim=-1)
        top_w, top_i = top_k_stable(scores, spec.top_k)
    top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-20)
    return scores, top_w, top_i


def moe_ffn(p: Params, spec: FfnSpec, x: torch.Tensor, *, rules=None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Top-k MoE. x: (B, S, D) -> (y, aux).

    With sharding rules (``rules``, else the active ones) whose mesh has
    a "model" axis the expert-parallel dispatch runs
    (``_moe_ffn_sharded``); otherwise the local one (``_moe_ffn_local``).
    aux carries the load-balance loss and per-expert slot counts (softmax
    router) or the counts only (sigmoid router, for DeepSeek-V3's
    aux-free bias update).
    """
    rules = rules if rules is not None else current_rules()
    if rules is not None and "model" in rules.mesh.axis_names:
        return _moe_ffn_sharded(p, spec, x, rules)
    return _moe_ffn_local(p, spec, x)


def moe_capacity(t: int, spec: FfnSpec) -> int:
    """Slots per expert: every token (dropless) while t * k <= 4096 (decode
    steps, short prompts), else the capacity-factor bound."""
    if t * spec.top_k <= 4096:
        return t
    return max(1, math.ceil(t * spec.top_k / spec.n_experts
                            * spec.capacity_factor))


def _dispatch(xt: torch.Tensor, top_i: torch.Tensor, e: int, cap: int,
              ) -> Tuple[torch.Tensor, tuple]:
    """Sort-based dispatch of (T, D) tokens into an (E * cap, D) buffer.

    The (T * k) slots are sorted by expert (stably: token-major order
    within an expert) and each expert keeps its first ``cap``; the rest go
    to a sink row and are dropped. Returns (buffer, route) where route
    is what ``_combine`` needs."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)                                  # (T*k,)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(sorted_e,
                                   torch.arange(e, device=xt.device))
    pos_in_seg = (torch.arange(t * k, device=xt.device)
                  - seg_start[sorted_e])
    keep = pos_in_seg < cap
    dest = torch.where(keep, sorted_e * cap + pos_in_seg, e * cap)
    buf = torch.zeros((e * cap + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    buf[dest] = xt[order // k]
    return buf[:e * cap], (order, keep, dest)


def _combine(y_flat: torch.Tensor, top_w: torch.Tensor, route: tuple,
             ) -> torch.Tensor:
    """Each token's k slot outputs from the (E * cap, D) expert outputs,
    weighted and summed in slot order: gathered through the inverse of the
    dispatch's sort, no scatter-add, so the sum is the same on every
    run. Dropped slots add 0."""
    order, keep, dest = route
    t, k = top_w.shape
    y_slots = torch.where(keep[:, None],
                          y_flat[torch.clamp_max(dest, y_flat.shape[0] - 1)],
                          0.0)
    w_slots = top_w.reshape(-1)[order][:, None].to(y_slots.dtype)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    contrib = (y_slots * w_slots)[inv].reshape(t, k, -1)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _experts(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor) -> torch.Tensor:
    """The experts as one batched product: (E, C, D) -> (E, C, D)."""
    return bmm(F.silu(bmm(buf, wg)) * bmm(buf, wu), wd)


def _expert_counts(top_i: torch.Tensor, e: int) -> torch.Tensor:
    """Slots per expert, float32: an exact scatter of ones (``bincount``
    has no meta kernel)."""
    flat = top_i.reshape(-1)
    return torch.zeros(e, dtype=torch.float32, device=flat.device
                       ).scatter_add_(0, flat, torch.ones(
                           flat.shape, dtype=torch.float32,
                           device=flat.device))


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    return matmul(F.silu(matmul(xt, p["ws_gate"]))
                  * matmul(xt, p["ws_up"]), p["ws_down"])


def _moe_ffn_local(p: Params, spec: FfnSpec, x: torch.Tensor,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sort-based top-k dispatch with the reference's semantics: every
    expert keeps its first ``moe_capacity`` slots (``_dispatch``), the
    experts run as one batched product over the (E, cap, D) buffer, and
    the slots combine in slot order (``_combine``)."""
    b, s, d = x.shape
    e, k = spec.n_experts, spec.top_k
    t = b * s
    xt = x.reshape(t, d)
    scores, top_w, top_i = _route(matmul(xt.float(), p["router"]), spec,
                                  p.get("router_bias"))
    cap = moe_capacity(t, spec)
    buf, route = _dispatch(xt, top_i, e, cap)
    y_flat = _experts(buf.reshape(e, cap, d), p["w_gate"], p["w_up"],
                      p["w_down"]).reshape(e * cap, d)
    y = _combine(y_flat, top_w, route)
    if spec.n_shared:
        y = y + _shared(p, xt)
    counts = _expert_counts(top_i, e)
    aux = {"expert_counts": counts}
    if spec.router != "sigmoid":
        # Switch-style load-balance loss.
        aux["lb_loss"] = e * torch.sum(counts / (t * k) * scores.mean(0))
    return y.reshape(b, s, d), aux


def _expert_axes(rules, e: int) -> Tuple[Tuple[str, ...], int]:
    """The axes experts are cut over: the rules' "experts" entry, or
    ("model",) when its size does not divide E (ref ``layers.py:896``)."""
    mesh = rules.mesh
    axes = tuple(a for a in (rules.table().get("experts") or ("model",))
                 if a in mesh.axis_names)
    size = mesh.axis_size(axes) if axes else 1
    if e % size:
        axes, size = ("model",), mesh.shape["model"]
    if e % size:
        raise ValueError(f"{e} experts do not split over {size} members")
    return axes, size


def moe_shard_capacity(t: int, n_members: int, spec: FfnSpec) -> int:
    """The expert-parallel path's slots per (source member, expert):
    ceil(t_local * k / E * capacity_factor), t padded to a multiple of
    the mesh size."""
    t_local = -(-t // n_members)
    return max(1, math.ceil(t_local * spec.top_k / spec.n_experts
                            * spec.capacity_factor))


def _moe_ffn_sharded(p: Params, spec: FfnSpec, x: torch.Tensor, rules,
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE over the rules' mesh (ref ``_moe_ffn_sharded``).

    Tokens are flattened to (T, D), zero-padded to a multiple of the mesh
    size and cut over every mesh member in order; experts are cut over
    ``_expert_axes`` (member r along them owns experts [r E_l, (r+1) E_l)).
    Each member routes its tokens (``_route``), packs an (E * cap, D)
    buffer with a per-(source, expert) capacity
    (``moe_shard_capacity``), and an ``all_to_all`` over the expert axes
    hands each owner its experts' rows from every source; the owner runs
    them as one batched product and a second ``all_to_all`` returns the
    results, which combine in slot order. The counts are summed and the
    router's mean probabilities averaged over every member
    (``all_reduce`` over all axes); the shared experts run unsharded on
    x's device. Returns (y on x's device, aux) as the local path.
    """
    mesh = rules.mesh
    devs = mesh.member_devices()
    all_axes = tuple(mesh.axis_names)
    e, k = spec.n_experts, spec.top_k
    b, s, d = x.shape
    t = b * s
    exp_axes, m_size = _expert_axes(rules, e)
    e_local = e // m_size
    n = mesh.size
    xt = x.reshape(t, d)
    xp = F.pad(xt, (0, 0, 0, -t % n))
    t_local = xp.shape[0] // n
    cap = moe_shard_capacity(t, n, spec)
    bias = p.get("router_bias")
    sends, routes, counts, probs = [], [], [], []
    for i, dev in enumerate(devs):
        xl = xp[i * t_local:(i + 1) * t_local].to(dev)
        scores, top_w, top_i = _route(
            matmul(xl.float(), p["router"].to(dev)), spec,
            bias.to(dev) if bias is not None else None)
        buf, route = _dispatch(xl, top_i, e, cap)
        sends.append(buf.reshape(m_size, e_local * cap, d))
        routes.append((top_w, route))
        counts.append(_expert_counts(top_i, e))
        probs.append(scores.mean(0))
    recv = collectives.all_to_all(sends, mesh, exp_axes)
    outs = []
    for i, dev in enumerate(devs):
        r = mesh.axis_index(i, exp_axes)
        w = [p[name][r * e_local:(r + 1) * e_local].to(dev)
             for name in ("w_gate", "w_up", "w_down")]
        hbuf = recv[i].reshape(m_size, e_local, cap, d).transpose(0, 1)
        y_e = _experts(hbuf.reshape(e_local, m_size * cap, d), *w)
        outs.append(y_e.reshape(e_local, m_size, cap, d).transpose(0, 1)
                    .reshape(m_size, e_local * cap, d))
    back = collectives.all_to_all(outs, mesh, exp_axes)
    y = torch.cat([_combine(back[i].reshape(e * cap, d), *routes[i]
                            ).to(x.device) for i in range(n)])[:t]
    if spec.n_shared:
        y = y + _shared(p, xt)
    counts = collectives.all_reduce(counts, mesh, all_axes)[0].to(x.device)
    aux = {"expert_counts": counts}
    if spec.router != "sigmoid":
        probs_mean = collectives.all_reduce(probs, mesh, all_axes)[0] / n
        frac = counts / torch.clamp_min(counts.sum(), 1.0)
        aux["lb_loss"] = e * torch.sum(frac * probs_mean.to(x.device))
    return y.reshape(b, s, d), aux


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

    def dt_bias():
        u = torch.rand((n_heads,), generator=gen, device=device) \
            * (hi - lo) + lo
        return torch.log(torch.expm1(torch.exp(u))).to(dtype)

    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": _zeros((conv_dim,), dtype, device),
        "a_log": _made(lambda: torch.log(torch.linspace(
            1.0, 16.0, n_heads, device=device)).to(dtype), (n_heads,), dtype),
        "d_skip": _made(lambda: torch.ones((n_heads,), dtype=dtype,
                                           device=device), (n_heads,), dtype),
        "dt_bias": _made(dt_bias, (n_heads,), dtype),
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

    # Mixed precision, either way round: x @ w_in promotes to float32, so
    # the conv, the chunk operands and y run in float32 until the last
    # cast.
    proj = matmul(x, p["w_in"])
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
    return matmul(y, p["w_out"]).to(x.dtype)


def ssd_decode(p: Params, spec: SsmSpec, d_model: int, x: torch.Tensor,
               cache: Dict[str, torch.Tensor],
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) per-token SSD decode. x: (B, 1, D).

    cache: {"state": (B,H,N,P), "conv": (B,W-1,convdim), "len": (B,)}.
    """
    b = x.shape[0]
    d_in = spec.expand * d_model
    proj = matmul(x, p["w_in"])  # (B,1,dproj)
    z, xbc, dt = _ssm_split(spec, d_model, proj)
    # Causal conv against the rolling window, in the promoted dtype: with
    # float32 params the bfloat16 conv cache comes back float32 after the
    # first step (the reference's concatenate); the state keeps its dtype.
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
    return matmul(y, p["w_out"]).to(x.dtype), {
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
