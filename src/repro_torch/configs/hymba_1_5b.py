"""Hymba-1.5B [arXiv:2411.13676].

Hybrid-head decoder: every layer runs attention and a Mamba(-2 style) SSM
head *in parallel* on the same input and fuses (mean) their outputs.
32L, d_model=1600, 25 heads GQA kv=5 (head_dim=64), d_ff=5504 (SwiGLU),
vocab=32001, ssm_state=16. Sliding-window 1024 attention everywhere
except three full-attention layers (first / middle / last) — Hymba's
published global-layer placement.
"""
from repro_torch.models.config import (
    AttnSpec, BlockSpec, FfnSpec, ModelConfig, SsmSpec,
)

_SWA = AttnSpec(kind="gqa", n_heads=25, n_kv_heads=5, head_dim=64,
                rope_theta=10_000.0, window=1024)
_GLOBAL = AttnSpec(kind="gqa", n_heads=25, n_kv_heads=5, head_dim=64,
                   rope_theta=10_000.0)
_SSM = SsmSpec(d_state=16, head_dim=64, expand=2, n_groups=1,
               conv_width=4, chunk=256)
_FFN = FfnSpec(kind="dense", d_ff=5_504, activation="silu_glu")


def _block(repeat: int, attn: AttnSpec) -> BlockSpec:
    return BlockSpec(repeat=repeat, mixer="hybrid", attn=attn, ssm=_SSM,
                     ffn=_FFN)


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        d_model=1_600,
        vocab_size=32_001,
        blocks=(
            _block(1, _GLOBAL),   # layer 0
            _block(14, _SWA),
            _block(1, _GLOBAL),   # middle
            _block(15, _SWA),
            _block(1, _GLOBAL),   # last
        ),
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    swa = AttnSpec(kind="gqa", n_heads=5, n_kv_heads=1, head_dim=16,
                   window=32)
    glob = AttnSpec(kind="gqa", n_heads=5, n_kv_heads=1, head_dim=16)
    ssm = SsmSpec(d_state=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=32)
    ffn = FfnSpec(kind="dense", d_ff=160, activation="silu_glu")
    return ModelConfig(
        name="hymba-1.5b-smoke",
        d_model=80,
        vocab_size=512,
        blocks=(
            BlockSpec(repeat=1, mixer="hybrid", attn=glob, ssm=ssm, ffn=ffn),
            BlockSpec(repeat=2, mixer="hybrid", attn=swa, ssm=ssm, ffn=ffn),
        ),
        tie_embeddings=True,
        remat=False,
    )
