"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434].

MLA attention (kv_lora_rank=512, no q-lora at Lite scale, qk 128 nope +
64 rope, v=128) over 27 layers, d_model=2048, 16 heads. FFN: layer 0 is
dense (d_ff=10944); layers 1..26 are MoE with 64 routed experts (top-6)
+ 2 shared, expert d_ff=1408, softmax router with load-balance loss.
vocab=102400.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_MLA = AttnSpec(kind="mla", n_heads=16, head_dim=192, q_lora_rank=None,
                kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_head_dim=128, rope_theta=10_000.0, n_kv_heads=16)
_DENSE = FfnSpec(kind="dense", d_ff=10_944, activation="silu_glu")
_MOE = FfnSpec(kind="moe", d_ff=10_944, activation="silu_glu",
               n_experts=64, n_shared=2, top_k=6, d_ff_expert=1_408,
               capacity_factor=1.25, router="softmax")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        d_model=2_048,
        vocab_size=102_400,
        blocks=(
            BlockSpec(repeat=1, mixer="attn", attn=_MLA, ffn=_DENSE),
            BlockSpec(repeat=26, mixer="attn", attn=_MLA, ffn=_MOE),
        ),
        tie_embeddings=False,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    mla = AttnSpec(kind="mla", n_heads=4, head_dim=48, q_lora_rank=None,
                   kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                   v_head_dim=32, n_kv_heads=4)
    dense = FfnSpec(kind="dense", d_ff=256, activation="silu_glu")
    moe = FfnSpec(kind="moe", d_ff=256, activation="silu_glu",
                  n_experts=8, n_shared=2, top_k=2, d_ff_expert=64,
                  router="softmax")
    return ModelConfig(
        name="deepseek-v2-lite-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(
            BlockSpec(repeat=1, mixer="attn", attn=mla, ffn=dense),
            BlockSpec(repeat=2, mixer="attn", attn=mla, ffn=moe),
        ),
        tie_embeddings=False,
        remat=False,
    )
