"""Gemma-3 1B [hf:google/gemma-3-1b-pt] — 5:1 local:global sliding
window, 262k vocab, head_dim 256, single KV head, tied embeddings; the
port's copy of ``repro/configs/gemma3_1b.py``.

``floe-slm-gemma3`` is the same geometry re-vocabed to the Floe cloud
LLM's 256k tokenizer (configs/floe_pair.py): the paper's
heterogeneity-aware edge SLM whose sliding-window layers the serving
engine keeps as window-sized ring caches (LM(ring_cache=True))."""
import dataclasses

from repro_torch.configs.base import ModelConfig, register


@register("gemma3-1b")
def gemma3_1b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=26,
        d_model=1_152,
        num_heads=4,
        num_kv_heads=1,
        head_dim=256,
        d_ff=6_912,
        vocab_size=262_144,
        attn_type="mixed",          # 5 sliding : 1 global
        sliding_window=512,
        global_every=6,
        rope_theta=10_000.0,
        rope_theta_global=1_000_000.0,
        use_qk_norm=True,
        mlp_type="geglu",
        tie_embeddings=True,
        embed_scale=True,
    )


@register("floe-slm-gemma3")
def floe_slm_gemma3() -> ModelConfig:
    """Gemma3-1B geometry as the Floe edge SLM: mixed 5:1 sliding/global
    attention (ring-cached at serve time), vocab matched to floe-llm-7b
    so the pair shares the fusion MLP's 2V input (Eq. 14)."""
    return dataclasses.replace(
        gemma3_1b(),
        name="floe-slm-gemma3",
        source="hf:google/gemma-3-1b-pt (re-vocabed to Gemma-7B pair)",
        vocab_size=256_000,
    )
