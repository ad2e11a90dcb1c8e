"""musicgen-medium — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf]. 48L, d_model 1536, 24H MHA, d_ff 6144, vocab 2048.

Backbone only (assignment): the EnCodec frontend is a stub — input_specs()
provides precomputed frame embeddings (B, T, d_model); the LM head predicts
codebook tokens (vocab 2048)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium", family="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048,
        input_mode="embeddings", rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128, dtype="float32", attn_impl="naive",
        loss_chunk=16)
