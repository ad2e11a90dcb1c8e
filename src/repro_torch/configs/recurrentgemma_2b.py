"""recurrentgemma-2b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427; hf]. 26L, d_model 2560, 10H MQA (kv=1), d_ff 7680,
vocab 256000, window 2048, tied embeddings, logit softcap 30."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1,
        head_dim=256, d_ff=7680, vocab_size=256_000,
        pattern=("rglru", "rglru", "local"), window=2048,
        lru_width=2560, conv_width=4, tie_embeddings=True,
        logit_softcap=30.0, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, window=16, lru_width=64,
        dtype="float32", attn_impl="naive", loss_chunk=16)
