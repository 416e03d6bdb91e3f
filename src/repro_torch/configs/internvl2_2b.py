"""InternVL2-2B [arXiv:2404.16821].

InternLM2-1.8B language backbone: 24L, d_model=2048, 16 heads GQA kv=8
(head_dim=128), d_ff=8192 SwiGLU, vocab=92553 (tied). The InternViT
vision tower is a STUB per the assignment: ``input_specs`` provides
precomputed patch features (B, 256, 1024) which a learned projection
maps into the token stream ahead of the text.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_ATTN = AttnSpec(kind="gqa", n_heads=16, n_kv_heads=8, head_dim=128,
                 rope_theta=1_000_000.0)
_FFN = FfnSpec(kind="dense", d_ff=8_192, activation="silu_glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        d_model=2_048,
        vocab_size=92_553,
        blocks=(BlockSpec(repeat=24, mixer="attn", attn=_ATTN, ffn=_FFN),),
        frontend="vision_patches",
        n_patches=256,
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(BlockSpec(
            repeat=2, mixer="attn",
            attn=AttnSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=32),
            ffn=FfnSpec(kind="dense", d_ff=256, activation="silu_glu")),),
        frontend="vision_patches",
        n_patches=16,
        tie_embeddings=True,
        remat=False,
    )
