"""mamba2-2.7b [ssm]: 64L d_model=2560, attn-free, vocab=50280,
ssm_state=128 [arXiv:2405.21060]. SSD (state-space duality) blocks:
d_inner=5120 (expand 2), head_dim 64 -> 80 heads, 1 group, conv width 4.
Sub-quadratic: runs the long_500k shape.

50280 is not divisible by the 16-way model axis; the embedding table is
padded to 50432 rows (tp_pad_vocab) so vocab/logits shard — the same
tensor-core padding the public mamba2 checkpoints apply (50288). Without
it the per-rank fp32 logits blow past HBM at train_4k (measured in the
v0 roofline; see EXPERIMENTS.md §Perf)."""

from repro_torch.models.config import ModelConfig, SSDConfig


def make_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=1,       # unused: attn-free
        n_kv_heads=1,
        head_dim=1,
        d_ff=0,
        vocab=50280,
        pattern=("ssd",),
        mlp_gated=False,
        tie_embeddings=True,
        tp_pad_vocab=50432,
        ssd=SSDConfig(d_state=128, head_dim=64, n_groups=1, conv_width=4,
                      expand=2, chunk=256),
    )
