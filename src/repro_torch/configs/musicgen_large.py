"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]. The EnCodec/text-conditioning frontend is a stub:
`input_specs()` provides precomputed frame embeddings (B, T, d_model);
the backbone is the transformer profiled here. Norm type unified to
RMSNorm framework-wide (noted in DESIGN.md)."""

from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab=2048,
        pattern=("attn",),
        mlp_gated=False,
        mlp_act="gelu",
        tie_embeddings=False,
        input_mode="embeddings",
    )
