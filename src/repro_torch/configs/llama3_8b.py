"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].
32L, d_model 4096, 32H (kv=8), head_dim 128, d_ff 14336, vocab 128256."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        head_dim=128, d_ff=14_336, vocab_size=128_256,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", attn_impl="naive",
        loss_chunk=16)
