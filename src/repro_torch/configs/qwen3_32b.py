"""qwen3-32b — dense GQA with qk-norm [hf:Qwen/Qwen3-8B family; hf].
64L, d_model 5120, 64H (kv=8), head_dim 128, d_ff 25600, vocab 151936."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=25_600, vocab_size=151_936,
        qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", attn_impl="naive",
        loss_chunk=16)
