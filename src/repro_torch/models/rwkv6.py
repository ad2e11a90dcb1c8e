"""RWKV-6 "Finch" time mixing and channel mixing (arXiv:2404.05892).

Counterpart of ``repro/models/rwkv6.py``, with the same parameter layout.
Attention-free: per head of 64 the time mix keeps a (D, D) state::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with a data-dependent decay ``w_t`` from a LoRA on the token-shifted
input. :func:`_wkv_scan` runs the recurrence as a loop over time in f32,
two operations a step; the state is O(1) in the sequence length, and
decode is one step of it.
The channel mix takes the block's MLP slot (``transformer`` wires it).
The per-head group norm takes the population variance, as ``jnp.var``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, matmul

_LORA = 64


def rwkv_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d = cfg.d_model
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    nh = d // cfg.rwkv_head_dim

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=dev)

    return {
        # token-shift lerp coefficients of r, k, v, w, g
        "mu": uniform((5, d)).to(dt),
        "wr": dense_init(gen, d, d, dt),
        "wk": dense_init(gen, d, d, dt),
        "wv": dense_init(gen, d, d, dt),
        "wg": dense_init(gen, d, d, dt),
        "wo": dense_init(gen, d, d, dt),
        # the data-dependent decay's LoRA: d -> 64 -> d
        "w_lora_a": dense_init(gen, d, _LORA, dt),
        "w_lora_b": dense_init(gen, _LORA, d, dt),
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "u": torch.randn((nh, cfg.rwkv_head_dim), generator=gen,
                         dtype=torch.float32, device=dev) * 0.1,
        "ln_x": torch.zeros((d,), dtype=torch.float32, device=dev),
        # channel mix
        "cm_mu": uniform((2, d)).to(dt),
        "cm_r": dense_init(gen, d, d, dt),
        "cm_k": dense_init(gen, d, cfg.d_ff, dt),
        "cm_v": dense_init(gen, cfg.d_ff, d, dt),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} sequence: ``prev`` (B, d) feeds position 0 of x
    (B, S, d)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, s0):
    """The wkv recurrence over time. r, k, v, w: (B, S, H, D) f32; u:
    (H, D); s0: (B, H, D, D). Returns (o (B, S, H, D), s_last).

    The bonus term ``r_t (diag(u) k_t^T v_t) = (r_t . (u * k_t)) v_t`` and
    the outer products ``k_t^T v_t`` are taken for every position at
    once, so a step of the loop is one product with the state and one
    fused update of it (the reference sums ``S_{t-1} + diag(u) k_t^T v_t``
    before its product with ``r_t``: the same function, rounded in
    another order). The reference's ``unroll`` knob (``cfg.wkv_unroll``,
    its state residency) does not change the result and has no
    counterpart here."""
    bonus = (r * u * k).sum(-1, keepdim=True) * v
    kv = k[..., :, None] * v[..., None, :]                 # (B,S,H,D,D)
    s, outs = s0, []
    for r_t, kv_t, w_t in zip(r.unbind(1), kv.unbind(1), w.unbind(1)):
        outs.append(torch.matmul(r_t[:, :, None, :], s)[:, :, 0])
        s = torch.addcmul(kv_t, w_t[..., None], s)
    return torch.stack(outs, dim=1) + bonus, s


def time_mix(cfg: ModelConfig, p: Dict, x: torch.Tensor,
             prev_tok: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) from the token before it ``prev_tok`` (B, d) and the
    state ``s0`` (B, H, D, D) -> (y, the last token, the last state)."""
    b, s, d = x.shape
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    xs = _token_shift(x, prev_tok)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i] * (xs - x) for i in range(5))
    r = matmul(xr, p["wr"]).reshape(b, s, nh, hd).float()
    k = matmul(xk, p["wk"]).reshape(b, s, nh, hd).float()
    v = matmul(xv, p["wv"]).reshape(b, s, nh, hd).float()
    g = F.silu(matmul(xg, p["wg"]).float())
    # the data-dependent decay: w = exp(-exp(base + lora(xw)))
    dw = matmul(torch.tanh(matmul(xw, p["w_lora_a"]).float()).to(x.dtype),
                p["w_lora_b"])
    w = torch.exp(-torch.exp(p["w_base"] + dw.float())).reshape(b, s, nh, hd)
    o, s_last = _wkv_scan(r, k, v, w, p["u"], s0)
    # per-head group norm
    o = (o - o.mean(-1, keepdim=True)) * torch.rsqrt(
        o.var(-1, keepdim=True, correction=0) + 64e-5)
    o = o.reshape(b, s, d) * (1.0 + p["ln_x"])
    y = matmul((o * g).to(x.dtype), p["wo"])
    return y, x[:, -1], s_last


def channel_mix(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                prev_tok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) from the token before it -> (y, the last token)."""
    xs = _token_shift(x, prev_tok)
    mu = p["cm_mu"].to(x.dtype)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    k = torch.square(torch.relu(matmul(xk, p["cm_k"]).float()))
    kv = matmul(k.to(x.dtype), p["cm_v"])
    r = torch.sigmoid(matmul(xr, p["cm_r"]).float()).to(x.dtype)
    return r * kv, x[:, -1]


def rwkv_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The time mix over a sequence from a zero state (the channel mix
    takes the block's MLP slot)."""
    b, d = x.shape[0], x.shape[2]
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    s0 = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    prev = torch.zeros((b, d), dtype=x.dtype, device=x.device)
    return time_mix(cfg, p, x, prev, s0)[0]


def rwkv_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """One step of the time mix. state: {"s": (B, H, D, D) f32,
    "tm_prev": (B, d), "cm_prev": (B, d)}, O(1) in the context length;
    ``cm_prev`` passes through (the channel mix updates it)."""
    y, tm_prev, s_last = time_mix(cfg, p, x, state["tm_prev"], state["s"])
    return y, {"s": s_last, "tm_prev": tm_prev, "cm_prev": state["cm_prev"]}


def rwkv_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device) -> Dict:
    d = cfg.d_model
    nh, hd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    return {"s": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
            "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device)}
