"""Falcon-Mamba-7B [arXiv:2410.05355] — pure Mamba-1, attention-free;
the port's copy of ``repro/configs/falcon_mamba_7b.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        source="arXiv:2410.05355",
        num_layers=64,
        d_model=4_096,
        num_heads=0,
        num_kv_heads=0,
        head_dim=0,
        d_ff=0,                     # attention-free: the mamba block only
        vocab_size=65_024,
        attn_type="none",
        ssm_version=1,
        ssm_state=16,
        ssm_conv=4,
        ssm_expand=2,
        lora_targets=("ssm_in", "ssm_out", "ssm_x", "ssm_dt"),
    )
