"""Heterogeneity-aware LoRA rank selection — paper Algorithm 1; the
port's copy of ``repro/core/rank_select.py``.

``PredictMemory``/``PredictLatency`` are look-up tables built by an
offline profiling pass (the paper profiles Jetson devices; we profile
*analytically* from the model config + device spec, which is the only
honest option on this box, and expose the same LUT interface so a real
deployment can swap in measured numbers).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_RANKS = (4, 8, 16, 32, 64)


@dataclass(frozen=True)
class DeviceProfile:
    """An edge device class (paper Table I)."""
    name: str
    memory_gb: float
    tflops: float                  # effective half-precision throughput
    mem_bw_gbs: float

    # runtime variance: fraction of compute stolen by foreground work
    def effective_tflops(self, background_load: float = 0.0) -> float:
        return self.tflops * max(0.05, 1.0 - background_load)


JETSON_ORIN_NX = DeviceProfile("jetson-orin-nx", 16.0, 50.0, 102.4)
JETSON_ORIN_NANO = DeviceProfile("jetson-orin-nano", 8.0, 20.0, 68.0)
JETSON_NANO = DeviceProfile("jetson-nano", 4.0, 0.5, 25.6)
DEVICE_CLASSES = (JETSON_ORIN_NX, JETSON_ORIN_NANO, JETSON_NANO)


def model_base_params(cfg) -> int:
    """Rough parameter count of the frozen SLM base (for memory LUT)."""
    d, l, v = cfg.d_model, cfg.num_layers, cfg.vocab_size
    per_layer = 0
    if cfg.num_heads:
        per_layer += d * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
        per_layer += cfg.num_heads * cfg.head_dim * d
    if cfg.d_ff:
        per_layer += 3 * d * cfg.d_ff
    if cfg.ssm_version:
        per_layer += 2 * d * cfg.d_inner + cfg.d_inner * d
    if cfg.num_experts:
        per_layer += 3 * d * cfg.moe_d_ff * cfg.num_experts
    return l * per_layer + v * d


def lora_params(cfg, rank: int) -> int:
    """Adapter parameters at ``rank`` over the model's LoRA layout (the
    layout depends on the config alone: no tensor is made)."""
    from repro_torch.models.model import LM
    total = 0
    for dims, targets in LM(cfg, device="cpu").lora_layout().values():
        n_layers = 1
        for x in dims:
            n_layers *= x
        for din, dout in targets.values():
            total += n_layers * rank * (din + dout)
    return total


@dataclass
class LUT:
    """(device, rank) -> (memory_bytes, latency_seconds)."""
    mem: Dict[Tuple[str, int], float] = field(default_factory=dict)
    lat: Dict[Tuple[str, int], float] = field(default_factory=dict)

    def predict_memory(self, device: str, rank: int) -> float:
        return self.mem[(device, rank)]

    def predict_latency(self, device: str, rank: int) -> float:
        return self.lat[(device, rank)]


def build_lut(cfg, ranks: Sequence[int] = DEFAULT_RANKS,
              devices: Sequence[DeviceProfile] = DEVICE_CLASSES,
              tokens_per_step: int = 2_048,
              background_load: float = 0.0) -> LUT:
    """Offline profiling pass (analytic): fwd+bwd FLOPs + optimizer memory."""
    lut = LUT()
    base = model_base_params(cfg)
    for dev in devices:
        for r in ranks:
            lp = lora_params(cfg, r)
            # bf16 frozen base + fp32 adapter (params+grads+Adam m,v)
            mem = 2.0 * base + 16.0 * lp + 2.0 * tokens_per_step * cfg.d_model * cfg.num_layers
            # fwd+bwd ≈ 6 N D on the adapted path; LoRA adds 6·lp·tokens
            flops = 6.0 * (base + lp) * tokens_per_step
            lat = flops / (dev.effective_tflops(background_load) * 1e12)
            lut.mem[(dev.name, r)] = mem
            lut.lat[(dev.name, r)] = lat
    return lut


def select_rank(ranks: Sequence[int], available_memory: float,
                deadline: float, lut: LUT, device: str) -> Optional[int]:
    """Paper Algorithm 1 — verbatim two-stage descending search."""
    r_selected = None
    for r in sorted(ranks, reverse=True):
        m_r = lut.predict_memory(device, r)
        # Stage 1: memory constraint
        if m_r <= available_memory:
            t_r = lut.predict_latency(device, r)
            # Stage 2: latency constraint
            if t_r <= deadline:
                r_selected = r
                return r_selected
    return r_selected
