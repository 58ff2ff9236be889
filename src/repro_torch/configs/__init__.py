"""Config registry — importing this package registers the port's archs."""
from repro_torch.configs.base import ModelConfig, get_config, list_archs  # noqa: F401
from repro_torch.configs import (falcon_mamba_7b, floe_pair,  # noqa: F401
                                 gemma3_1b, granite_moe_3b, zamba2_7b)
