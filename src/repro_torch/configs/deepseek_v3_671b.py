"""DeepSeek-V3 (671B total / 37B active) [arXiv:2412.19437].

MLA (q_lora=1536, kv_lora=512, qk 128 nope + 64 rope, v=128), 61 layers,
d_model=7168, 128 heads. First 3 layers dense (d_ff=18432); 58 MoE layers
with 256 routed experts (top-8, sigmoid router + aux-free bias balancing)
+ 1 shared expert, expert d_ff=2048. vocab=129280. One-depth MTP head.
"""
from repro_torch.models.config import AttnSpec, BlockSpec, FfnSpec, ModelConfig

_MLA = AttnSpec(kind="mla", n_heads=128, head_dim=192, q_lora_rank=1_536,
                kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                v_head_dim=128, rope_theta=10_000.0, n_kv_heads=128)
_DENSE = FfnSpec(kind="dense", d_ff=18_432, activation="silu_glu")
_MOE = FfnSpec(kind="moe", d_ff=18_432, activation="silu_glu",
               n_experts=256, n_shared=1, top_k=8, d_ff_expert=2_048,
               capacity_factor=1.25, router="sigmoid")


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=7_168,
        vocab_size=129_280,
        blocks=(
            BlockSpec(repeat=3, mixer="attn", attn=_MLA, ffn=_DENSE),
            BlockSpec(repeat=58, mixer="attn", attn=_MLA, ffn=_MOE),
        ),
        tie_embeddings=False,
        mtp_depth=1,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
        fsdp=True,
    )


def smoke_config() -> ModelConfig:
    mla = AttnSpec(kind="mla", n_heads=4, head_dim=48, q_lora_rank=48,
                   kv_lora_rank=64, qk_nope_dim=32, qk_rope_dim=16,
                   v_head_dim=32, n_kv_heads=4)
    dense = FfnSpec(kind="dense", d_ff=256, activation="silu_glu")
    moe = FfnSpec(kind="moe", d_ff=256, activation="silu_glu",
                  n_experts=8, n_shared=1, top_k=2, d_ff_expert=64,
                  router="sigmoid")
    return ModelConfig(
        name="deepseek-v3-smoke",
        d_model=128,
        vocab_size=512,
        blocks=(
            BlockSpec(repeat=1, mixer="attn", attn=mla, ffn=dense),
            BlockSpec(repeat=2, mixer="attn", attn=mla, ffn=moe),
        ),
        tie_embeddings=False,
        mtp_depth=1,
        remat=False,
    )
