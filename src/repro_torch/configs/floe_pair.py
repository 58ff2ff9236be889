"""The paper's own model pair (Sec. V-A2): a cloud "LLM" and an edge "SLM"
in the Gemma-7B / Gemma-2B proportion — the port's copy of
``repro/configs/floe_pair.py``.

``FLOE_PAIRS`` names the servable (SLM, LLM) pairings; both members
share a vocab so the Eq. 14 alignment MLP concatenates their
distributions.  The ``gemma3`` pair puts the mixed-attention SLM
(``configs/gemma3_1b.py``: grouped 5:1 sliding/global layout, ring
caches at serve time) beside the same cloud LLM (Sec. 4
heterogeneity-aware edge models).
"""
from typing import Tuple

from repro_torch.configs.base import ModelConfig, register

FLOE_PAIRS = {
    "2b": ("floe-slm-2b", "floe-llm-7b"),
    "gemma3": ("floe-slm-gemma3", "floe-llm-7b"),
}


def needs_ring_cache(cfg: ModelConfig) -> bool:
    """Whether an edge SLM should be built with LM(ring_cache=True):
    windowed layers then keep window-sized ring caches at serve time."""
    return cfg.attn_type in ("sliding", "mixed")


def pair_configs(pair: str, reduced: bool = True
                 ) -> Tuple[ModelConfig, ModelConfig]:
    """Resolve a FLOE_PAIRS name to (slm_cfg, llm_cfg); build the SLM
    with LM(cfg, ring_cache=needs_ring_cache(cfg))."""
    from repro_torch.configs.base import get_config
    sname, lname = FLOE_PAIRS[pair]
    scfg, lcfg = get_config(sname), get_config(lname)
    return (scfg.reduced(), lcfg.reduced()) if reduced else (scfg, lcfg)


@register("floe-llm-7b")
def floe_llm_7b() -> ModelConfig:
    # Gemma-7B geometry [arXiv:2403.08295]
    return ModelConfig(
        name="floe-llm-7b",
        family="dense",
        source="arXiv:2403.08295 (Gemma-7B)",
        num_layers=28,
        d_model=3_072,
        num_heads=16,
        num_kv_heads=16,
        head_dim=256,
        d_ff=24_576,
        vocab_size=256_000,
        attn_type="full",
        mlp_type="geglu",
        tie_embeddings=True,
        embed_scale=True,
    )


@register("floe-slm-2b")
def floe_slm_2b() -> ModelConfig:
    # Gemma-2B geometry [arXiv:2403.08295]
    return ModelConfig(
        name="floe-slm-2b",
        family="dense",
        source="arXiv:2403.08295 (Gemma-2B)",
        num_layers=18,
        d_model=2_048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        vocab_size=256_000,
        attn_type="full",
        mlp_type="geglu",
        tie_embeddings=True,
        embed_scale=True,
    )
