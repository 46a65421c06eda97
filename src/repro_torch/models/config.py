"""Model configuration dataclasses.

One `ModelConfig` describes any of the assigned architectures through a
cycled per-layer *block pattern* (e.g. ``("attn",)``,
``("local", "global")``, ``("rglru", "rglru", "local")``, ``("ssd",)``,
``("moe",)``). Layers are grouped for `lax.scan`: `n_layers // len(pattern)`
full groups are scanned; the remainder ("tail") layers are unrolled.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block kinds implying a full-attention mixer (=> quadratic in context;
# archs containing any of these skip the long_500k shape).
FULL_ATTN_KINDS = ("attn", "global", "moe")
# Block kinds with an attention mixer at all (need a KV cache).
ATTN_KINDS = ("attn", "global", "local", "moe")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSDConfig:
    """Mamba2 state-space-duality mixer."""
    d_state: int = 128
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    expand: int = 2
    chunk: int = 256  # SSD chunk length (training/prefill)


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU recurrent mixer."""
    lru_width: int = 0  # defaults to d_model
    conv_width: int = 4
    c: float = 8.0  # recurrence sharpness constant


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    pattern: Tuple[str, ...] = ("attn",)
    window: int = 0  # sliding window for "local" blocks
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    qk_norm: bool = False
    sandwich_norm: bool = False  # gemma2-style post-block norms
    rotary_pct: float = 1.0
    rope_theta: float = 10000.0
    mlp_gated: bool = True
    mlp_act: str = "silu"  # silu | gelu
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma-style sqrt(d_model) input scaling
    input_mode: str = "tokens"  # tokens | embeddings (audio/vlm frontend stubs)
    norm_eps: float = 1e-6

    moe: Optional[MoEConfig] = None
    ssd: Optional[SSDConfig] = None
    rglru: Optional[RGLRUConfig] = None

    # TP head padding: smallest multiple of the model-axis size >= n_heads.
    # 0 means "no padding needed". Only deepseek-coder-33b (56 heads) uses it.
    tp_pad_heads: int = 0
    # TP vocab padding (embedding rows added so vocab shards over the model
    # axis). Only mamba2 (50280) needs it. 0 = no padding.
    tp_pad_vocab: int = 0

    # Runtime knobs (not architecture):
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_impl: str = "auto"  # auto | naive | cuda
    attn_chunk: int = 512
    remat: str = "none"  # none | block | moe_save (checkpoint around each group)

    def __post_init__(self):
        if self.pattern and any(k in ATTN_KINDS for k in self.pattern):
            assert self.n_heads % self.n_kv_heads == 0, \
                f"{self.name}: n_heads {self.n_heads} must be a multiple " \
                f"of n_kv_heads {self.n_kv_heads}"
            if self.tp_pad_heads:
                assert self.tp_pad_heads >= self.n_heads

    # ---- derived helpers -------------------------------------------------
    @property
    def q_heads_padded(self) -> int:
        return self.tp_pad_heads if self.tp_pad_heads else self.n_heads

    @property
    def padded_vocab(self) -> int:
        return self.tp_pad_vocab if self.tp_pad_vocab else self.vocab

    @property
    def n_groups_scan(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_kinds(self) -> Tuple[str, ...]:
        tail = self.n_layers % len(self.pattern)
        return self.pattern[:tail]

    @property
    def is_subquadratic(self) -> bool:
        """True iff no block kind uses full (unwindowed) attention."""
        return not any(k in FULL_ATTN_KINDS for k in self.pattern)

    @property
    def uses_attention(self) -> bool:
        return any(k in ATTN_KINDS for k in self.pattern)

    @property
    def d_inner_ssd(self) -> int:
        assert self.ssd is not None
        return self.ssd.expand * self.d_model

    @property
    def ssd_heads(self) -> int:
        assert self.ssd is not None
        return self.d_inner_ssd // self.ssd.head_dim

    @property
    def lru_width(self) -> int:
        assert self.rglru is not None
        return self.rglru.lru_width or self.d_model

    def with_runtime(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (analytic; cross-checked against the actual
    # tree in tests) --------------------------------------------------------
    def _block_params(self, kind: str) -> int:
        d = self.d_model
        n = 0
        if kind in ATTN_KINDS:
            hq = self.q_heads_padded * self.head_dim
            hkv = self.n_kv_heads * self.head_dim
            n += d * hq + 2 * d * hkv + hq * d  # q, k, v, o
            n += 2 * d  # ln1 + ln2
            if self.qk_norm:
                n += 2 * self.head_dim
            if self.sandwich_norm:
                n += 2 * d
        if kind == "moe":
            m = self.moe
            n += d * m.n_experts  # router
            gate = 1 if self.mlp_gated else 0
            n += m.n_experts * ((2 + gate - 1) * d * m.d_ff_expert + m.d_ff_expert * d)
        elif kind in ("attn", "global", "local"):
            gate = 1 if self.mlp_gated else 0
            n += (1 + gate) * d * self.d_ff + self.d_ff * d
        elif kind == "rglru":
            w = self.lru_width
            cw = self.rglru.conv_width
            n += 2 * d * w  # x branch + gate branch in-proj
            n += w * cw  # temporal conv
            n += 3 * w  # a-gate, i-gate (diagonal params) + Lambda
            n += 2 * w * w  # recurrent input/recurrence gates (dense per RG-LRU)
            n += w * d  # out proj
            n += 2 * d  # ln1 + ln2 (mixer norm + mlp norm)
            gate = 1 if self.mlp_gated else 0
            n += (1 + gate) * d * self.d_ff + self.d_ff * d
        elif kind == "ssd":
            s = self.ssd
            di = self.d_inner_ssd
            nh = self.ssd_heads
            conv_ch = di + 2 * s.n_groups * s.d_state
            n += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            n += conv_ch * s.conv_width  # conv
            n += 2 * nh  # A_log, dt_bias
            n += nh  # D skip
            n += di  # gated norm
            n += di * d  # out_proj
            n += d  # ln1
        return n

    def param_count(self) -> int:
        n = self.padded_vocab * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.padded_vocab * self.d_model
        n += self.d_model  # final norm
        for i in range(self.n_layers):
            n += self._block_params(self.pattern[i % len(self.pattern)])
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        n = self.param_count()
        if self.moe is not None:
            m = self.moe
            gate = 1 if self.mlp_gated else 0
            per_expert = (1 + gate) * self.d_model * m.d_ff_expert + m.d_ff_expert * self.d_model
            n_moe_layers = sum(
                1 for i in range(self.n_layers)
                if self.pattern[i % len(self.pattern)] == "moe"
            )
            n -= n_moe_layers * (m.n_experts - m.top_k) * per_expert
        return n
