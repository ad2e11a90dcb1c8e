"""command-r-plus-104b — dense GQA, no biases
[hf:CohereForAI/c4ai-command-r family; unverified].
64L, d_model 12288, 96H (kv=8), head_dim 128, d_ff 33792, vocab 256000."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b", family="dense",
        n_layers=64, d_model=12_288, n_heads=96, n_kv_heads=8,
        head_dim=128, d_ff=33_792, vocab_size=256_000,
        rope_theta=75_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", attn_impl="naive",
        loss_chunk=16)
