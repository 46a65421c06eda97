"""Model substrate of the port: configs, layers, parameter trees and the
forward / prefill / decode entry points (attention-only patterns)."""

from repro_torch.models.config import ModelConfig, MoEConfig, SSDConfig, RGLRUConfig
from repro_torch.models.model import (
    init_params,
    forward,
    init_cache,
    decode_step,
    prefill,
)
from repro_torch.models.params import from_jax

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSDConfig",
    "RGLRUConfig",
    "init_params",
    "forward",
    "init_cache",
    "decode_step",
    "prefill",
    "from_jax",
]
