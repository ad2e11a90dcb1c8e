"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8) + MTP
[arXiv:2412.19437; hf]. 61L, d_model 7168, 128 MLA heads, vocab 129280.

Assignment lists d_ff=2048: that is the per-expert (moe_intermediate_size)
width; the first_k_dense=3 dense layers use the published 18432."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        head_dim=128, d_ff=18_432, vocab_size=129_280,
        n_experts=256, top_k=8, n_shared_experts=1, d_ff_expert=2048,
        first_k_dense=3, router_score="sigmoid", capacity_factor=1.25,
        mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
        mtp=True, rope_theta=10_000.0,
    )


def smoke() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, n_experts=4, top_k=2, d_ff_expert=32,
        first_k_dense=1, q_lora_rank=32, kv_lora_rank=16,
        qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        dtype="float32", attn_impl="naive", loss_chunk=16)
