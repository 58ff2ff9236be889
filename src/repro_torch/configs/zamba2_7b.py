"""Zamba2-7B [arXiv:2411.15242] — a Mamba-2 backbone with one SHARED
attention block interleaved (weight-tied), ssm_state 64; the port's
copy of ``repro/configs/zamba2_7b.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-7b")
def zamba2_7b() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=81,
        d_model=3_584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14_336,
        vocab_size=32_000,
        attn_type="sliding",        # shared attn blocks run windowed for 500k
        sliding_window=4_096,
        rope_theta=10_000.0,
        mlp_type="swiglu",
        ssm_version=2,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        attn_every=6,               # 1 shared attention block every 6 layers
        shared_attention=True,
    )
