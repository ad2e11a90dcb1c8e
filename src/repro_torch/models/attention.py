"""GQA attention: full-sequence paths (naive and chunked causal) and the
one-token decode path over a KV cache.

Counterpart of the GQA part of ``repro/models/attention.py``, with the
same parameter layouts (wq (d, H, Dh), wk/wv (d, Kh, Dh), wo (H, Dh, d)).
Two differences of the port, neither of function:

- decode attention of a global layer runs through kernel B8
  (:func:`repro_torch.kernels.ops.flash_decode`) with ``lengths =
  min(pos + 1, S)``, which is exactly the reference's mask
  ``cache_pos <= pos``. B8 keeps the softmax weights in f32 for the
  product with v, where the reference rounds them to the compute dtype
  first: the same in f32 configs, a bf16 rounding apart in bf16 ones;
- the decode path writes the new K/V row into the cache in place (the
  reference returns an updated copy, donated under jit). A write at
  ``pos >= S`` is dropped, as the reference's one-hot scatter drops it.

Sliding-window decode (``local`` blocks) and MLA raise
``NotImplementedError``: they come with the recurrentgemma and deepseek
slices.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

NEG_INF = -1e30


# ================================================================== params
def attn_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    p = {
        "wq": dense_init(gen, d, h * dh, dt).reshape(d, h, dh),
        "wk": dense_init(gen, d, kh * dh, dt).reshape(d, kh, dh),
        "wv": dense_init(gen, d, kh * dh, dt).reshape(d, kh, dh),
        "wo": dense_init(gen, h * dh, d, dt).reshape(h, dh, d),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, dh), dtype=dt, device=dev)
        p["bk"] = torch.zeros((kh, dh), dtype=dt, device=dev)
        p["bv"] = torch.zeros((kh, dh), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((dh,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.zeros((dh,), dtype=torch.float32, device=dev)
    return p


# ============================================================ QKV plumbing
def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) times w (d, n, Dh) -> (B, S, n, Dh) in x's dtype."""
    b, s, d = x.shape
    return torch.matmul(x, w.reshape(d, -1)).to(x.dtype).reshape(
        b, s, w.shape[1], w.shape[2])


def _out_proj(out: torch.Tensor, wo: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """out (B, S, H, Dh) times wo (H, Dh, d) -> (B, S, d)."""
    b, s = out.shape[:2]
    return torch.matmul(out.reshape(b, s, -1),
                        wo.reshape(-1, wo.shape[-1])).to(dtype)


def _qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor,
         positions: torch.Tensor):
    """x: (B, S, d) -> q (B, S, H, Dh), k/v (B, S, Kh, Dh), rope applied."""
    q, k, v = (_project(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, s, kh, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, groups, dh).reshape(
        b, s, kh * groups, dh)


# ========================================================== full-seq paths
def _naive_attention(q, k, v, positions, window: int) -> torch.Tensor:
    """(B,S,H,D) x (B,S,H,D) -> (B,S,H,D); causal (+optional window)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    pq = positions[:, :, None]
    pk = positions[:, None, :]
    mask = pq >= pk
    if window > 0:
        mask &= (pq - pk) < window
    w = torch.softmax(scores.masked_fill(~mask[:, None], NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def _chunked_attention(q, k, v, positions, window: int,
                       cq: int, ckv: int) -> torch.Tensor:
    """Flash-style causal attention, exact-triangle FLOPs: each query chunk
    scans only the KV chunks its causal (and window) footprint reaches,
    carrying the online softmax (m, l, acc). Peak scores (B, H, cq, ckv)."""
    b, s, h, dh = q.shape
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    cq = min(cq, s)
    ckv = min(ckv, s)
    if s % cq or s % ckv:
        raise ValueError(f"sequence {s} is not a multiple of the chunks "
                         f"({cq}, {ckv})")
    outs = []
    for i in range(s // cq):
        q_i = q[:, i * cq:(i + 1) * cq].float()
        pq = positions[:, i * cq:(i + 1) * cq]
        hi = (i + 1) * cq
        lo = max(0, (i * cq - window) // ckv * ckv) if window > 0 else 0
        n_kv = -(-(hi - lo) // ckv)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, h, cq, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(n_kv):
            # the reference slices n_kv * ckv positions from lo, clamped
            # to the end of the sequence like dynamic_slice
            st = min(lo, s - n_kv * ckv) + j * ckv
            k_j = k[:, st:st + ckv].float()
            v_j = v[:, st:st + ckv]
            p_j = positions[:, st:st + ckv]
            sc = torch.einsum("bqhd,bkhd->bhqk", q_i, k_j) * scale
            msk = pq[:, :, None] >= p_j[:, None, :]
            if window > 0:
                msk &= (pq[:, :, None] - p_j[:, None, :]) < window
            sc = sc.masked_fill(~msk[:, None], NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p_ = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p_.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd", p_.to(q.dtype).float(),
                              v_j.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out_i = (acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype)
        outs.append(out_i.transpose(1, 2))
    return torch.cat(outs, dim=1)


def _full_attention(cfg: ModelConfig, q, k, v, positions,
                    window: int) -> torch.Tensor:
    s = q.shape[1]
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "naive" if s <= max(cfg.attn_chunk_q, 512) else "chunked"
    if impl == "naive":
        return _naive_attention(q, k, v, positions, window)
    return _chunked_attention(q, k, v, positions, window, cfg.attn_chunk_q,
                              cfg.attn_chunk_kv)


def attention_block(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                    positions: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Full-sequence GQA attention (prefill, forward)."""
    q, k, v = _qkv(cfg, p, x, positions)
    groups = cfg.n_heads // cfg.n_kv_heads
    out = _full_attention(cfg, q, _repeat_kv(k, groups),
                          _repeat_kv(v, groups), positions, window)
    return _out_proj(out, p["wo"], x.dtype)


# ============================================================== decode path
def attn_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                cache_k: torch.Tensor, cache_v: torch.Tensor,
                pos: torch.Tensor, *, window: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: (B, 1, d); cache_{k,v}: (B, S, Kh, Dh), written
    in place; pos: (B,) int32 absolute position of the new token. Returns
    (y (B, 1, d), cache_k, cache_v)."""
    if window > 0:
        raise NotImplementedError("sliding-window decode (local blocks) "
                                  "comes with the recurrentgemma slice")
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    q, k_new, v_new = _qkv(cfg, p, x, pos[:, None])
    _scatter_cache(cache_k, k_new, pos)
    _scatter_cache(cache_v, v_new, pos)
    lengths = torch.clamp(pos + 1, max=s_cache).to(torch.int32)
    out = ops.flash_decode(q[:, 0].contiguous(), cache_k, cache_v, lengths)
    out = out.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    return _out_proj(out, p["wo"], x.dtype), cache_k, cache_v


def _scatter_cache(cache: torch.Tensor, new: torch.Tensor,
                   slot: torch.Tensor) -> None:
    """cache (B, S, Kh, D) <- new (B, 1, Kh, D) at row ``slot[b]`` of each
    sequence, in place. A slot at or past S is dropped (the row it would
    land on is written back unchanged), as the reference's one-hot drops
    it; nothing is read back to the host."""
    s_cache = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.clamp(slot.long(), max=s_cache - 1)
    keep = (slot < s_cache)[:, None, None]
    cache[rows, at] = torch.where(keep, new[:, 0].to(cache.dtype),
                                  cache[rows, at])


def _cache_positions(pos: torch.Tensor, s_cache: int,
                     window: int) -> torch.Tensor:
    """Absolute position stored at each cache slot (ring-aware)."""
    idx = torch.arange(s_cache, device=pos.device)[None, :]
    if window <= 0:
        return idx.expand(pos.shape[0], s_cache)
    cur = pos[:, None].long()
    return cur - torch.remainder(cur - idx, s_cache)
