"""Model configuration — one dataclass covering all 10 assigned families
(a copy of the JAX package's ``models/config.py``, which imports no JAX).

``blocks()`` expands the per-layer block kinds ("<mixer>:<mlp>"); the
transformer groups consecutive equal kinds into runs (see
``transformer._runs``) whose parameters are stacked on a leading layer
axis, so RecurrentGemma's (rglru, rglru, local) interleave and DeepSeek's
dense-prefix + MoE-suffix stay exact.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention options
    qk_norm: bool = False           # qwen3
    qkv_bias: bool = False          # qwen1.5
    rope_theta: float = 10_000.0
    window: int = 0                 # sliding-window size for 'local' blocks
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # layer pattern (cycled to n_layers); kinds: attn | local | rglru | rwkv
    pattern: Tuple[str, ...] = ("attn",)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0          # deepseek: first k layers use dense MLP
    capacity_factor: float = 1.25
    router_score: str = "softmax"   # softmax | sigmoid (deepseek/llama4)

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    mtp: bool = False               # deepseek multi-token prediction head

    # RG-LRU (recurrentgemma / griffin)
    lru_width: int = 0              # 0 -> d_model
    conv_width: int = 4

    # RWKV6
    rwkv_head_dim: int = 64
    wkv_unroll: int = 1             # scan unroll: keeps the (D,D) state in
                                    # registers across steps (see §Perf rwkv)

    # modality frontend: tokens | embeddings (audio/vlm stubs feed embeddings)
    input_mode: str = "tokens"

    # numerics / memory
    dtype: str = "bfloat16"
    norm_f32: bool = True           # False: bf16 norm math (f32 mean accum)
    remat: str = "full"             # none | full | dots
    attn_impl: str = "auto"         # auto | naive | chunked
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    loss_chunk: int = 512           # seq chunk for the vocab-safe CE

    # ---------------------------------------------------------------- utils
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def lru_width_(self) -> int:
        return self.lru_width or self.d_model

    def mlp_kind(self, layer: int) -> str:
        if self.n_experts > 0 and layer >= self.first_k_dense:
            return "moe"
        return "dense"

    def blocks(self) -> List[str]:
        """Per-layer '<mixer>:<mlp>' kinds."""
        out = []
        for i in range(self.n_layers):
            mixer = self.pattern[i % len(self.pattern)]
            out.append(f"{mixer}:{self.mlp_kind(i)}")
        return out

    def supports_long_context(self) -> bool:
        """True iff decode cost is sub-quadratic in context (SSM/hybrid):
        every mixer is recurrent or window-bounded."""
        return all(m in ("rglru", "rwkv", "local")
                   for m in (self.pattern[i % len(self.pattern)]
                             for i in range(self.n_layers)))

    def n_params(self) -> int:
        """Exact parameter count (embedding + blocks + head)."""
        d, dh = self.d_model, self.head_dim_
        n = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size  # lm head
        n += d  # final norm
        for i, kind in enumerate(self.blocks()):
            mixer, mlp = kind.split(":")
            n += 2 * d  # two pre-norms
            if mixer == "attn" or mixer == "local":
                if self.mla:
                    qh = self.qk_nope_dim + self.qk_rope_dim
                    n += d * self.q_lora_rank + self.q_lora_rank  # q down + norm
                    n += self.q_lora_rank * self.n_heads * qh     # q up
                    n += d * (self.kv_lora_rank + self.qk_rope_dim)
                    n += self.kv_lora_rank                         # kv norm
                    n += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    n += self.n_heads * self.v_head_dim * d        # out
                else:
                    n += d * self.n_heads * dh          # wq
                    n += 2 * d * self.n_kv_heads * dh   # wk, wv
                    n += self.n_heads * dh * d          # wo
                    if self.qkv_bias:
                        n += (self.n_heads + 2 * self.n_kv_heads) * dh
                    if self.qk_norm:
                        n += 2 * dh
            elif mixer == "rglru":
                w = self.lru_width_
                n += 2 * d * w + w * d      # in x2 branches, out
                n += self.conv_width * w    # temporal conv
                n += 3 * w                  # lambda, input-gate, rec-gate proj diag-ish
                n += 2 * w * w // 8         # block-diag gate projections (8 blocks)
            elif mixer == "rwkv":
                n += 6 * d                  # token-shift lerp mus (r,k,v,w,g,x)
                n += 5 * d * d              # r,k,v,g,o projections
                n += 2 * d * 64 + 64 * d    # w lora (time-decay)
                n += d                      # u (bonus)
            if mlp == "dense":
                n += 3 * d * self.d_ff      # swiglu
            else:
                n += d * self.n_experts     # router
                n += self.n_experts * 3 * d * self.d_ff_expert
                n += self.n_shared_experts * 3 * d * self.d_ff_expert
        if self.mtp:
            # one extra block (attn:dense with d_ff_expert-sized MLP) + proj
            n += 2 * d * self.vocab_size // self.vocab_size  # negligible norms
            n += 4 * d * dh * self.n_heads
            n += 2 * d * d
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
