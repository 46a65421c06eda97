"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 [arXiv:2402.19427]. RG-LRU + local attention in a 1:2
pattern — (rglru, rglru, local) cycled: 8 full groups + 2 tail RG-LRU
layers. Window 2048. Sub-quadratic: runs the long_500k shape.

10 q-heads are not divisible by the 16-way model axis: tp_pad_heads=16
pads the (minority) local-attention mixers; the ~2% total param overhead
is surfaced by the roofline MODEL_FLOPS/HLO_FLOPs ratio (DESIGN.md §6)."""

from repro_torch.models.config import ModelConfig, RGLRUConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256000,
        pattern=("rglru", "rglru", "local"),
        window=2048,
        mlp_gated=True,
        mlp_act="gelu",
        tie_embeddings=True,
        embed_scale=True,
        tp_pad_heads=16,
        rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    )
