"""Mamba2-130M [arXiv:2405.21060].

Attention-free SSD (state-space duality) stack: 24L, d_model=768,
d_inner=1536 (expand 2, 24 SSD heads of P=64), d_state N=128, 1 B/C
group, conv width 4, vocab=50280, tied embeddings.
"""
from repro_torch.models.config import BlockSpec, FfnSpec, ModelConfig, SsmSpec

_SSM = SsmSpec(d_state=128, head_dim=64, expand=2, n_groups=1,
               conv_width=4, chunk=256)


def config() -> ModelConfig:
    # Mamba blocks have no separate FFN: the SSM mixer is the layer.
    # d_ff=0 in the assignment table; we honour it with a pass-through
    # dense FFN of zero cost? No — mamba literally has no FFN, so the
    # block uses mixer-only layout: the FfnSpec below is never applied
    # (see transformer._layer_forward: mamba arch uses ffn d_ff == 0
    # marker -> identity). Cleanest encoding: two SSD mixers per "layer
    # pair" is NOT mamba2; instead mark kind="dense", d_ff=0.
    ffn = FfnSpec(kind="dense", d_ff=0, activation="silu_glu")
    return ModelConfig(
        name="mamba2-130m",
        d_model=768,
        vocab_size=50_280,
        blocks=(BlockSpec(repeat=24, mixer="ssm", ssm=_SSM, ffn=ffn),),
        tie_embeddings=True,
        param_dtype="bfloat16",
        activation_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    ssm = SsmSpec(d_state=32, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=32)
    return ModelConfig(
        name="mamba2-130m-smoke",
        d_model=64,
        vocab_size=512,
        blocks=(BlockSpec(repeat=2, mixer="ssm", ssm=ssm,
                          ffn=FfnSpec(kind="dense", d_ff=0,
                                      activation="silu_glu")),),
        tie_embeddings=True,
        remat=False,
    )
