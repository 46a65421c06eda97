"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 [arXiv:2405.09818]. Early-fusion over VQ image tokens; the
VQ tokenizer frontend is a stub (`input_specs()` provides precomputed
patch embeddings). QK-norm per the paper."""

from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b",
        family="vlm",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=22016,
        vocab=65536,
        pattern=("attn",),
        qk_norm=True,
        mlp_gated=True,
        mlp_act="silu",
        tie_embeddings=False,
        input_mode="embeddings",
    )
