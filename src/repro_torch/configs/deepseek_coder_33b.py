"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8)
d_ff=19200 vocab=32256 [arXiv:2401.14196]. Llama-architecture.

56 q-heads are not divisible by the fixed 16-way model axis, so
`tp_pad_heads=64` pads attention to 64 heads (zero-init extras). The
~14% attention-FLOP padding waste is surfaced by the roofline table's
MODEL_FLOPS/HLO_FLOPs ratio (DESIGN.md §6)."""

from repro_torch.models.config import ModelConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab=32256,
        pattern=("attn",),
        rope_theta=100000.0,
        mlp_gated=True,
        mlp_act="silu",
        tie_embeddings=False,
        tp_pad_heads=64,
    )
