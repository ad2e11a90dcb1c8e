"""Shared neural building blocks, on plain tensors.

Counterpart of ``repro/models/layers.py``, rounding where it rounds:

- parameters are nested dicts of tensors, in the JAX package's layouts;
- the compute dtype is ``cfg.dtype``; norms, RoPE angles and softmax run
  in float32;
- every product accumulates in float32 and is rounded to the input's
  dtype (``torch.matmul`` does this for bf16 operands), except the logits
  head, which returns float32.

The initialisers draw from an explicit :class:`torch.Generator` on the
target device, so the same seed gives the same weights on the same device
(not the JAX package's weights: a test carries those over with
:func:`repro_torch.models.transformer.params_from_numpy`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last axis of ``x``, accumulated in f32 and
    rounded to ``x.dtype``."""
    return torch.matmul(x, w).to(x.dtype)


# ------------------------------------------------------------------- init
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1/d_in) weights, drawn in f32 and rounded to ``dtype``."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) embedding table, drawn in f32 and rounded to ``dtype``."""
    return torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                       device=gen.device).to(dtype)


# ---------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, device) -> torch.Tensor:
    """Zeros: the gemma-style ``(1 + w)`` parameterisation."""
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            f32: bool = True) -> torch.Tensor:
    """RMSNorm with scale ``1 + w``. ``f32=True`` normalises in float32;
    ``f32=False`` squares in ``x.dtype``, takes the mean in float32 and
    scales in ``x.dtype``, as the reference's bf16 norm does."""
    if f32:
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * (1.0 + w.float())
        return y.to(x.dtype)
    var = torch.mean((x * x).float(), dim=-1, keepdim=True)
    scale = torch.rsqrt(var + eps) * (1.0 + w.float())
    return x * scale.to(x.dtype)


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """f32 inverse frequencies ``1 / theta^(2i / head_dim)`` (the base
    stays a host scalar: a device copy of it would synchronise)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding over the last axis, split halves (not interleaved
    pairs), f32 angles. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                              # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- SwiGLU
def swiglu_init(gen: torch.Generator, d: int, d_ff: int,
                dtype: torch.dtype) -> dict:
    return {"gate": dense_init(gen, d, d_ff, dtype),
            "up": dense_init(gen, d, d_ff, dtype),
            "down": dense_init(gen, d_ff, d, dtype)}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = matmul(x, p["gate"])
    u = matmul(x, p["up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return matmul(h, p["down"])


# -------------------------------------------------------------- embedding
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 scale: bool = True) -> torch.Tensor:
    """Rows of ``table`` times ``sqrt(d)`` rounded to the table's dtype
    (a multiply in that dtype, as the reference does). The factor is a
    0-dim host tensor, which PyTorch reads as a scalar: no copy to the
    device and no synchronisation."""
    out = table[tokens.long()]
    if scale:
        out = out * torch.tensor(math.sqrt(table.shape[1]), dtype=out.dtype)
    return out


def unembed(x: torch.Tensor, table: torch.Tensor,
            softcap: float = 0.0) -> torch.Tensor:
    """Logits head: ``x @ table.T`` with table (V, d), returned in float32
    (products of the operands' dtype are exact in f32, so upcasting both
    and multiplying in f32 is the reference's f32-accumulated product)."""
    logits = torch.matmul(x.float(), table.float().T)
    if softcap > 0.0:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
