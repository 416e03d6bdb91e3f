"""Nemotron-4-340B [arXiv:2402.16819].

Dense decoder: 96L, d_model=18432, 96 heads GQA kv=8 (head_dim=192),
d_ff=73728 with squared-ReLU (no gating), vocab=256000, untied.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_ATTN = AttnSpec(kind="gqa", n_heads=96, n_kv_heads=8, head_dim=192,
                 rope_theta=10_000.0)
_FFN = FfnSpec(kind="dense", d_ff=73_728, activation="squared_relu")


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b",
        d_model=18_432,
        vocab_size=256_000,
        blocks=(BlockSpec(repeat=96, mixer="attn", attn=_ATTN, ffn=_FFN),),
        tie_embeddings=False,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        d_model=192,
        vocab_size=512,
        blocks=(BlockSpec(
            repeat=2, mixer="attn",
            attn=AttnSpec(kind="gqa", n_heads=6, n_kv_heads=2, head_dim=32),
            ffn=FfnSpec(kind="dense", d_ff=768,
                        activation="squared_relu")),),
        tie_embeddings=False,
        remat=False,
    )
