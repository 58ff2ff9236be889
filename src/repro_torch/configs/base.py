"""Model configuration — the port's own copy of ``repro/configs/base.py``.

Every architecture is one frozen ``ModelConfig``; ``reduced()`` derives
the CPU-smoke variant (2 layers, d_model<=256) of the same family.  The
field set and ``reduced()`` are kept identical to the reference so the
two packages build the same shapes from the same name.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    source: str                      # citation for the config numbers
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free archs
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---------------------------------------------------------
    attn_type: str = "full"          # full | sliding | mixed | none
    sliding_window: int = 4096
    global_every: int = 0            # "mixed": 1 global layer every N (gemma3: 6)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3 uses 1M for global layers
    use_qk_norm: bool = False

    # --- MLP ---------------------------------------------------------------
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25

    # --- MLA ---------------------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM ---------------------------------------------------------------
    ssm_version: int = 0
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1

    # --- hybrid ------------------------------------------------------------
    attn_every: int = 0
    shared_attention: bool = False

    # --- encoder/decoder ---------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500

    # --- modality frontend stubs -------------------------------------------
    frontend: str = "none"
    num_patches: int = 0

    # --- misc ---------------------------------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: x *= sqrt(d_model)
    dtype: str = "bfloat16"

    # --- Floe integration ---------------------------------------------------
    lora_targets: Tuple[str, ...] = ("q", "kv", "o", "mlp_in", "mlp_out")
    lora_rank_max: int = 16
    num_lora_experts: int = 4

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        # mamba1 convention: ceil(d_model / 16)
        return -(-self.d_model // 16)

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_version == 2 else 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/code path, tiny dims."""
        d = min(self.d_model, 256)
        heads = 0 if self.num_heads == 0 else max(2, min(self.num_heads, 4))
        kvh = 0 if self.num_kv_heads == 0 else max(1, min(self.num_kv_heads, 2))
        hd = 0 if heads == 0 else max(16, min(self.head_dim, 32))
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d,
            num_heads=heads,
            num_kv_heads=kvh,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16),
            global_every=min(self.global_every, 2) if self.global_every else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            moe_d_ff=min(self.moe_d_ff, 128) if self.moe_d_ff else 0,
            first_k_dense=min(self.first_k_dense, 1),
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.kv_lora_rank else 0,
            q_lora_rank=min(self.q_lora_rank, 32) if self.q_lora_rank else 0,
            qk_nope_dim=min(self.qk_nope_dim, 16) if self.qk_nope_dim else 0,
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.qk_rope_dim else 0,
            v_head_dim=min(self.v_head_dim, 16) if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 16),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 16),
            num_patches=min(self.num_patches, 8) if self.num_patches else 0,
            capacity_factor=8.0,
            lora_rank_max=4,
            num_lora_experts=2,
            dtype="float32",
        )
        return replace(self, **kw)


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c  # noqa: F401  (registers archs)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
