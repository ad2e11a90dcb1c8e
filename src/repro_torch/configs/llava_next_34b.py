"""llava-next-34b — VLM (anyres tiling) on a Yi-34B-class backbone
[hf:llava-hf/llava-v1.6 family; unverified].
60L, d_model 7168, 56H (kv=8), head_dim 128, d_ff 20480, vocab 64000.

Backbone only (assignment): the vision tower + anyres tiling is a stub —
input_specs() provides precomputed patch embeddings (B, T, d_model)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b", family="vlm",
        n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
        head_dim=128, d_ff=20_480, vocab_size=64_000,
        input_mode="embeddings", rope_theta=5_000_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, dtype="float32", attn_impl="naive",
        loss_chunk=16)
