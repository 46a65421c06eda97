"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 [arXiv:2408.00118]. Local+global alternating attention
(window 4096), attention logit softcap 50, final logit softcap 30,
sandwich (pre+post) norms, gated GELU, sqrt(d) embedding scaling,
head_dim 256."""

from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab=256000,
        pattern=("local", "global"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        sandwich_norm=True,
        mlp_gated=True,
        mlp_act="gelu",
        tie_embeddings=True,
        embed_scale=True,
    )
