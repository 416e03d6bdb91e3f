"""Gemma-3-12B [hf:google/gemma-3-12b family].

Dense decoder with the 5:1 local:global attention pattern: 48 layers as
8 repetitions of [5x sliding-window-1024 local + 1x global]; GQA 16H/8KV
head_dim=256 (d_model=3840), d_ff=15360 GeGLU, vocab=262144 (tied),
rope_theta 10k local / 1M global, 128k context.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_LOCAL = AttnSpec(kind="gqa", n_heads=16, n_kv_heads=8, head_dim=256,
                  rope_theta=10_000.0, window=1024)
_GLOBAL = AttnSpec(kind="gqa", n_heads=16, n_kv_heads=8, head_dim=256,
                   rope_theta=1_000_000.0)
_FFN = FfnSpec(kind="dense", d_ff=15_360, activation="gelu_glu")


def config() -> ModelConfig:
    pattern = []
    for _ in range(8):  # 8 x (5 local + 1 global) = 48 layers
        pattern.append(BlockSpec(repeat=5, mixer="attn", attn=_LOCAL,
                                 ffn=_FFN))
        pattern.append(BlockSpec(repeat=1, mixer="attn", attn=_GLOBAL,
                                 ffn=_FFN))
    return ModelConfig(
        name="gemma3-12b",
        d_model=3_840,
        vocab_size=262_144,
        blocks=tuple(pattern),
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    local = AttnSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=32,
                     rope_theta=10_000.0, window=64)
    glob = AttnSpec(kind="gqa", n_heads=4, n_kv_heads=2, head_dim=32,
                    rope_theta=1_000_000.0)
    ffn = FfnSpec(kind="dense", d_ff=256, activation="gelu_glu")
    return ModelConfig(
        name="gemma3-12b-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(
            BlockSpec(repeat=2, mixer="attn", attn=local, ffn=ffn),
            BlockSpec(repeat=1, mixer="attn", attn=glob, ffn=ffn),
        ),
        tie_embeddings=True,
        remat=False,
    )
