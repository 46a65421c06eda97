"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4)
d_ff_expert=1536 vocab=151936, MoE 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B family scaling]. QK-norm, head_dim 128,
rope theta 1e6. Expert-parallel dispatch (128 % 16 == 0)."""

from repro_torch.models.config import ModelConfig, MoEConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,  # every FFN is MoE
        vocab=151936,
        pattern=("moe",),
        qk_norm=True,
        rope_theta=1e6,
        mlp_gated=True,
        mlp_act="silu",
        tie_embeddings=False,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536,
                      capacity_factor=1.25),
    )
