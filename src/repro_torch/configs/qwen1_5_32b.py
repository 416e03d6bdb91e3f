"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B family].

Dense llama-style decoder with QKV bias (the Qwen signature): 64L,
d_model=5120, 40 heads (MHA: kv=40, head_dim=128), d_ff=27392 (SwiGLU),
vocab=152064. Untied embeddings at this scale.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_ATTN = AttnSpec(kind="gqa", n_heads=40, n_kv_heads=40, head_dim=128,
                 qkv_bias=True, rope_theta=1_000_000.0)
_FFN = FfnSpec(kind="dense", d_ff=27_392, activation="silu_glu")


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        d_model=5_120,
        vocab_size=152_064,
        blocks=(BlockSpec(repeat=64, mixer="attn", attn=_ATTN, ffn=_FFN),),
        tie_embeddings=False,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(BlockSpec(
            repeat=2, mixer="attn",
            attn=AttnSpec(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=32,
                          qkv_bias=True, rope_theta=1_000_000.0),
            ffn=FfnSpec(kind="dense", d_ff=384, activation="silu_glu")),),
        tie_embeddings=False,
        remat=False,
    )
