"""qwen1.5-110b — dense GQA with QKV bias [hf:Qwen/Qwen1.5 family; hf].
80L, d_model 8192, 64H (kv=8), head_dim 128, d_ff 49152, vocab 152064."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1_5-110b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        head_dim=128, d_ff=49_152, vocab_size=152_064,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", attn_impl="naive",
        loss_chunk=16)
