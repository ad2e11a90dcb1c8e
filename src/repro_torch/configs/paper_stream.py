"""The paper's own configuration: the stream-simulation pipeline defaults
(§5 evaluation setup) — datasets, time ranges, and the consumer model used
by the end-to-end examples (a ~100M-param LM trained on simulated streams)."""

from repro_torch.models.config import ModelConfig

DATASETS = ("sogouq", "traffic", "userbehavior")
TIME_RANGES = (600, 1200, 1800, 2400, 3000, 3600)  # the paper's six
ORIGINAL_RANGE = 86_400


def consumer_lm() -> ModelConfig:
    """~100M-parameter decoder-only LM used as the SPS task in examples."""
    return ModelConfig(
        name="stream-consumer-100m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2048, vocab_size=32_768,
        dtype="float32", attn_impl="naive", loss_chunk=128,
        remat="none",
    )
