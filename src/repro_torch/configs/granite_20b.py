"""Granite-20B (code) [arXiv:2405.04324].

Decoder with extreme KV sharing: 52L, d_model=6144, 48 heads with a
single KV head (MQA, kv=1, head_dim=128), d_ff=24576 (4x, non-gated GELU
— the GPT-BigCode lineage of the Granite code models), vocab=49152.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_ATTN = AttnSpec(kind="gqa", n_heads=48, n_kv_heads=1, head_dim=128,
                 rope_theta=10_000.0)
_FFN = FfnSpec(kind="dense", d_ff=24_576, activation="gelu")


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        d_model=6_144,
        vocab_size=49_152,
        blocks=(BlockSpec(repeat=52, mixer="attn", attn=_ATTN, ffn=_FFN),),
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(BlockSpec(
            repeat=2, mixer="attn",
            attn=AttnSpec(kind="gqa", n_heads=4, n_kv_heads=1, head_dim=32),
            ffn=FfnSpec(kind="dense", d_ff=512, activation="gelu")),),
        tie_embeddings=True,
        remat=False,
    )
