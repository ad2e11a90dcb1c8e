"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early
fusion [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
48L, d_model 5120, 40H (kv=8), head_dim 128, expert d_ff 8192, vocab 202048."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=8192, vocab_size=202_048,
        n_experts=16, top_k=1, n_shared_experts=1, d_ff_expert=8192,
        first_k_dense=0, router_score="sigmoid", capacity_factor=1.25,
        rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, vocab_size=512, n_experts=4, top_k=1, d_ff_expert=64,
        dtype="float32", attn_impl="naive", loss_chunk=16)
