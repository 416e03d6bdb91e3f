"""Model configuration schema: architectures are data, not code forks.

A copy of ``repro.models.config``, field for field (the port keeps its
own: it imports nothing of the JAX package). The port's forward pass
loops over the layers of a group instead of scanning them.

A model is a stack of *block groups*; each group is ``repeat`` identical
layers described by one ``BlockSpec`` (mixer + FFN + geometry). The
forward pass scans within a group (one compile per group, not per layer)
and chains groups in order. This one schema expresses all ten assigned
architectures:

  dense GQA          -> one group, mixer="attn"
  gemma3 5:1 pattern -> repeating [5x local, 1x global] groups
  deepseek dense+MoE -> [k x dense-FFN group, (L-k) x MoE group]
  mamba2             -> one group, mixer="ssm"
  hymba              -> groups with mixer="hybrid" (parallel attn + SSM),
                        full-attention groups at ends/middle
  musicgen           -> cross_attn=True groups + 4 codebook heads
  internvl2          -> vision-patch stub frontend + dense groups
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Attention mixer settings (GQA or MLA)."""

    kind: str = "gqa"                 # "gqa" | "mla"
    n_heads: int = 16
    n_kv_heads: int = 16              # GQA: kv head count (1 = MQA)
    head_dim: int = 128
    qkv_bias: bool = False            # qwen1.5
    rope_theta: float = 10_000.0
    window: Optional[int] = None      # sliding window; None = global
    logit_softcap: Optional[float] = None
    # -- MLA (deepseek) ------------------------------------------------------
    q_lora_rank: Optional[int] = None     # None = direct q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    def __post_init__(self):
        if self.kind not in ("gqa", "mla"):
            raise ValueError(f"bad attn kind {self.kind!r}")
        if self.kind == "gqa" and self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")


@dataclasses.dataclass(frozen=True)
class SsmSpec:
    """Mamba-2 (SSD) mixer settings."""

    d_state: int = 128        # N
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    n_groups: int = 1         # B/C groups (G)
    conv_width: int = 4
    chunk: int = 256          # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class FfnSpec:
    """FFN settings: dense or MoE."""

    kind: str = "dense"           # "dense" | "moe"
    d_ff: int = 4096
    activation: str = "silu_glu"  # "silu_glu" | "gelu_glu" | "gelu"
    #                               | "squared_relu"
    # -- MoE ---------------------------------------------------------------------
    n_experts: int = 0            # routed experts
    n_shared: int = 0             # always-on shared experts
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router: str = "softmax"       # "softmax" | "sigmoid" (dsv3 aux-free)

    def __post_init__(self):
        if self.kind not in ("dense", "moe"):
            raise ValueError(f"bad ffn kind {self.kind!r}")
        ok = ("silu_glu", "gelu_glu", "gelu", "squared_relu")
        if self.activation not in ok:
            raise ValueError(f"bad activation {self.activation!r}")
        if self.kind == "moe" and (self.n_experts <= 0
                                   or self.d_ff_expert <= 0):
            raise ValueError("moe needs n_experts and d_ff_expert")


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """``repeat`` identical transformer layers."""

    repeat: int
    mixer: str = "attn"           # "attn" | "ssm" | "hybrid"
    attn: Optional[AttnSpec] = None
    ssm: Optional[SsmSpec] = None
    ffn: FfnSpec = FfnSpec()
    cross_attn: bool = False      # musicgen: cross-attend to conditioning

    def __post_init__(self):
        if self.mixer in ("attn", "hybrid") and self.attn is None:
            raise ValueError(f"mixer {self.mixer!r} needs attn spec")
        if self.mixer in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"mixer {self.mixer!r} needs ssm spec")
        if self.repeat <= 0:
            raise ValueError("repeat must be positive")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level architecture description."""

    name: str
    d_model: int
    vocab_size: int
    blocks: Tuple[BlockSpec, ...]
    # Modality frontend: "none" (token ids), "audio_frames" (precomputed
    # frame embeddings + codebook heads), "vision_patches" (patch
    # embeddings prepended to token embeddings).
    frontend: str = "none"
    n_codebooks: int = 1            # musicgen: output heads per position
    n_cond_tokens: int = 0          # cross-attention memory length
    n_patches: int = 0              # vlm: patch tokens per sample
    tie_embeddings: bool = True
    rms_eps: float = 1e-5
    mtp_depth: int = 0              # deepseek-v3 multi-token prediction
    # Embedding tables are padded so the vocab dim shards cleanly over
    # any mesh axis (MaxText-style). Logits over padded ids are live but
    # never targeted; samplers slice [:vocab_size].
    vocab_pad_to: int = 256
    # -- numerics / execution ---------------------------------------------------
    param_dtype: str = "float32"    # smoke tests; dry-run uses bfloat16
    activation_dtype: str = "float32"
    remat: bool = True              # activation checkpointing per layer
    # -- parallelism ---------------------------------------------------------------
    fsdp: bool = False              # shard params over the data axis too
    shard_seq: bool = False         # long-context: shard KV/seq on model
    # Sequence-parallel flash decode: attention over the seq-sharded KV
    # cache computed shard-locally (online-softmax partials) and merged
    # with tiny psums, instead of letting GSPMD all-gather the cache.
    # §Perf hillclimb lever for collective-bound decode cells.
    seq_parallel_decode: bool = False
    # int8 KV cache (GQA layers): rows stored int8 with per-(pos, head)
    # scales; exact-algebra dequant inside the attention einsums. Halves
    # the decode-cell cache residency vs bf16 — the remedy for the MHA
    # 32k-context cells that exceed one pod's HBM.
    kv_cache_quant: bool = False

    def __post_init__(self):
        if self.frontend not in ("none", "audio_frames", "vision_patches"):
            raise ValueError(f"bad frontend {self.frontend!r}")
        if not self.blocks:
            raise ValueError("need at least one block group")

    @property
    def n_layers(self) -> int:
        return sum(b.repeat for b in self.blocks)

    @property
    def padded_vocab(self) -> int:
        pad = self.vocab_pad_to
        return -(-self.vocab_size // pad) * pad

    # -- analytics (roofline / memory audits) ----------------------------------
    def param_count(self) -> int:
        """Exact parameter count (embeddings + blocks + heads)."""
        d = self.d_model
        total = self.padded_vocab * d  # embedding (padded for sharding)
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        if self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * self.padded_vocab * d
        if self.frontend == "vision_patches":
            total += 1024 * d  # patch projection stub (from ViT dim 1024)
        for b in self.blocks:
            total += b.repeat * self._layer_params(b)
        total += d  # final norm
        if self.mtp_depth:
            mtp_block = self.blocks[-1]
            total += self.mtp_depth * (self._layer_params(mtp_block)
                                       + 2 * d * d)  # combine proj
        return total

    def _layer_params(self, b: BlockSpec) -> int:
        d = self.d_model
        has_ffn = not (b.ffn.kind == "dense" and b.ffn.d_ff == 0)
        n = 2 * d if has_ffn else d  # pre-mixer (+ pre-ffn) rmsnorms
        if b.mixer in ("attn", "hybrid"):
            a = b.attn
            if a.kind == "gqa":
                qkv = d * a.n_heads * a.head_dim \
                    + 2 * d * a.n_kv_heads * a.head_dim
                if a.qkv_bias:
                    qkv += (a.n_heads + 2 * a.n_kv_heads) * a.head_dim
                n += qkv + a.n_heads * a.head_dim * d
            else:  # mla
                qk_dim = a.qk_nope_dim + a.qk_rope_dim
                if a.q_lora_rank:
                    n += d * a.q_lora_rank \
                        + a.q_lora_rank * a.n_heads * qk_dim
                else:
                    n += d * a.n_heads * qk_dim
                n += d * (a.kv_lora_rank + a.qk_rope_dim)
                n += a.kv_lora_rank * a.n_heads * (a.qk_nope_dim
                                                   + a.v_head_dim)
                n += a.n_heads * a.v_head_dim * d
        if b.mixer in ("ssm", "hybrid"):
            s = b.ssm
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)
            n += conv_dim * s.conv_width
            n += 2 * n_heads          # A_log, D
            n += n_heads              # dt_bias
            n += d_in * d             # out proj
            n += d_in                 # gate norm
        if b.cross_attn:
            a = b.attn
            n += d  # extra norm
            n += 2 * d * a.n_heads * a.head_dim \
                + a.n_heads * a.head_dim * d + d * a.n_heads * a.head_dim
        f = b.ffn
        if f.kind == "dense":
            mult = 3 if f.activation.endswith("_glu") else 2
            n += mult * d * f.d_ff
        else:
            mult = 3  # deepseek experts are glu
            n += d * f.n_experts  # router
            n += f.n_experts * mult * d * f.d_ff_expert
            n += f.n_shared * mult * d * f.d_ff_expert
            if f.router == "sigmoid":
                n += f.n_experts  # aux-free bias
        return n

    def active_param_count(self) -> int:
        """Active (per-token) parameters — MoE counts top_k + shared."""
        d = self.d_model
        total = self.padded_vocab * d + d
        if not self.tie_embeddings:
            total += self.padded_vocab * d
        for b in self.blocks:
            full = self._layer_params(b)
            f = b.ffn
            if f.kind == "moe":
                mult = 3
                routed_all = f.n_experts * mult * d * f.d_ff_expert
                routed_active = f.top_k * mult * d * f.d_ff_expert
                full = full - routed_all + routed_active
            total += b.repeat * full
        return total
