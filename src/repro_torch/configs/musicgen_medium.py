"""MusicGen-medium [arXiv:2306.05284].

Decoder-only over EnCodec tokens: 48L, d_model=1536, 24 heads MHA
(head_dim=64), d_ff=6144 (non-gated GELU, fairseq lineage), vocab=2048
per codebook with 4 codebooks (delay pattern), cross-attention to text
conditioning every layer. The EnCodec/T5 frontends are STUBS per the
assignment: ``input_specs`` provides precomputed frame embeddings
(B, S, d_model) and conditioning embeddings (B, 64, d_model).
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_ATTN = AttnSpec(kind="gqa", n_heads=24, n_kv_heads=24, head_dim=64,
                 rope_theta=10_000.0)
_FFN = FfnSpec(kind="dense", d_ff=6_144, activation="gelu")


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        d_model=1_536,
        vocab_size=2_048,
        blocks=(BlockSpec(repeat=48, mixer="attn", attn=_ATTN, ffn=_FFN,
                          cross_attn=True),),
        frontend="audio_frames",
        n_codebooks=4,
        n_cond_tokens=64,
        tie_embeddings=False,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke",
        d_model=96,
        vocab_size=256,
        blocks=(BlockSpec(
            repeat=2, mixer="attn",
            attn=AttnSpec(kind="gqa", n_heads=4, n_kv_heads=4, head_dim=24),
            ffn=FfnSpec(kind="dense", d_ff=256, activation="gelu"),
            cross_attn=True),),
        frontend="audio_frames",
        n_codebooks=4,
        n_cond_tokens=8,
        tie_embeddings=False,
        remat=False,
    )
