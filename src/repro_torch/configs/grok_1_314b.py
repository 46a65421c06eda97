"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2 [hf:xai-org/grok-1]. Attention and
final logit softcap 30, sqrt(d) embedding scaling, tied embeddings.
E=8 < 16-way model axis -> ff-slice TP expert sharding (moe_mode=tp)."""

from repro_torch.models.config import ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=0,  # every FFN is MoE
        vocab=131072,
        pattern=("moe",),
        attn_softcap=30.0,
        final_softcap=30.0,
        mlp_gated=True,
        mlp_act="gelu",
        tie_embeddings=True,
        embed_scale=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768,
                      capacity_factor=1.25),
    )
