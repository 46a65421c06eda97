"""stablelm-1.6b [dense]: 24L d_model=2048 32H (GQA kv=32) d_ff=5632
vocab=100352 [hf:stabilityai/stablelm-2-1_6b]. Partial rotary (25%)."""

from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab=100352,
        pattern=("attn",),
        rotary_pct=0.25,
        mlp_gated=True,
        mlp_act="silu",
        tie_embeddings=False,
    )
