"""Architecture registry. Each <arch>.py exposes `make_config()` with the
exact published hyper-parameters; `reduced_config(name)` scales a family
down for CPU tests (same block pattern, tiny dims). Every architecture
runs on this package; the MoE ones (qwen3, grok) on the unsharded path
(`models/moe.py`)."""

from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = [
    "musicgen_large",
    "stablelm_1_6b",
    "gemma2_9b",
    "yi_9b",
    "deepseek_coder_33b",
    "recurrentgemma_2b",
    "chameleon_34b",
    "mamba2_2_7b",
    "qwen3_moe_235b",
    "grok_1_314b",
]

# Canonical external ids (assignment spelling) -> module names.
ALIASES = {
    "musicgen-large": "musicgen_large",
    "stablelm-1.6b": "stablelm_1_6b",
    "gemma2-9b": "gemma2_9b",
    "yi-9b": "yi_9b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "chameleon-34b": "chameleon_34b",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "grok-1-314b": "grok_1_314b",
}


def resolve(name: str) -> str:
    name = ALIASES.get(name, name)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get_config(name: str, **runtime):
    mod = importlib.import_module(f"repro_torch.configs.{resolve(name)}")
    cfg = mod.make_config()
    return cfg.with_runtime(**runtime) if runtime else cfg


def reduced_config(name: str, **runtime):
    """Tiny same-family config for CPU tests."""
    from repro_torch.models.config import MoEConfig, RGLRUConfig, SSDConfig
    cfg = get_config(name)
    pat = len(cfg.pattern)
    n_layers = pat * 2 + (1 if cfg.n_layers % pat else 0)  # 2 groups (+tail)
    kw = dict(
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        window=8 if cfg.window else 0,
        tp_pad_heads=0,
        attn_chunk=16,
    )
    if cfg.moe:
        kw["moe"] = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                              capacity_factor=2.0)
    if cfg.ssd:
        kw["ssd"] = SSDConfig(d_state=16, head_dim=8, n_groups=1,
                              conv_width=4, expand=2, chunk=16)
    if cfg.rglru:
        kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4)
    cfg = dataclasses.replace(cfg, **kw)
    return cfg.with_runtime(**runtime) if runtime else cfg
