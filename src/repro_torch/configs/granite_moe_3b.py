"""Granite-MoE 3B-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base family] —
40 experts, top-8, tiny per-expert FFN; the port's copy of
``repro/configs/granite_moe_3b.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("granite-moe-3b-a800m")
def granite_moe_3b() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (family card)",
        num_layers=32,
        d_model=1_536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                   # per-expert hidden dim
        vocab_size=49_155,
        attn_type="full",
        rope_theta=10_000.0,
        mlp_type="swiglu",
        num_experts=40,
        experts_per_token=8,
        moe_d_ff=512,
        tie_embeddings=True,
    )
