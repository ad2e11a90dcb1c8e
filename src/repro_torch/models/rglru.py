"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``, with the same parameter layout.
The temporal-mixing block is ``x -> [linear -> GeLU] * [linear -> causal
conv1d (width 4) -> RG-LRU] -> linear``, and the RG-LRU recurrence, per
channel, is::

    r_t = sigmoid(W_a x_t)          recurrence gate
    i_t = sigmoid(W_x x_t)          input gate
    a_t = exp(-c softplus(lambda) r_t),   c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The gates are block-diagonal projections (8 blocks), in f32, and so are
the decay, its ``sqrt(max(1 - a^2, 1e-12))`` input gate and the state.
The GeLU is the tanh approximation, ``jax.nn.gelu``'s default.

Over a sequence the recurrence is linear in h, so :func:`rglru_scan` runs
it as a log-depth scan on tensors: the odd/even recursion of
``jax.lax.associative_scan``, step for step, so the products and sums are
taken in the reference's order. Decode is one O(1) state update.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, matmul

_C = 8.0
_BLOCKS = 8


def rglru_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d, w = cfg.d_model, cfg.lru_width_
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    bw = w // _BLOCKS
    # lambda so that a^c ~ U[0.9, 0.999] (Griffin's appendix)
    u = torch.empty((w,), dtype=torch.float32, device=dev).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.exp(-torch.log(u) / _C) - 1.0)

    def block_diag():
        return dense_init(gen, bw, _BLOCKS * bw, torch.float32).reshape(
            bw, _BLOCKS, bw).transpose(0, 1).contiguous()

    return {
        "in_gelu": dense_init(gen, d, w, dt),
        "in_rnn": dense_init(gen, d, w, dt),
        "conv_w": (torch.randn((cfg.conv_width, w), generator=gen,
                               dtype=torch.float32, device=dev)
                   / math.sqrt(cfg.conv_width)).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=dev),
        "gate_a": block_diag(),
        "gate_x": block_diag(),
        "lambda": lam,
        "out": dense_init(gen, w, d, dt),
    }


def _gates(p: Dict, x: torch.Tensor):
    """Block-diagonal gate projections of x (..., W) f32: (r, i)."""
    shp, w = x.shape[:-1], x.shape[-1]
    xb = x.reshape(shp + (_BLOCKS, w // _BLOCKS))
    r = torch.sigmoid(torch.einsum("...bi,bij->...bj", xb, p["gate_a"]))
    i = torch.sigmoid(torch.einsum("...bi,bij->...bj", xb, p["gate_x"]))
    return r.reshape(shp + (w,)), i.reshape(shp + (w,))


def _conv1d(p: Dict, x: torch.Tensor, state: torch.Tensor = None):
    """Causal depthwise conv of width K. x: (B, S, W); state: (B, K-1, W),
    the inputs before x, or None (zeros). Returns (out, new state)."""
    k = p["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(k))
    new_state = xp[:, -(k - 1):] if k > 1 else pad
    return out + p["conv_b"], new_state


def _rglru_coeffs(p: Dict, x: torch.Tensor):
    """(a_t, b_t), the decay and the input of the linear recurrence, f32."""
    xf = x.float()
    r, i = _gates(p, xf)
    log_a = -_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    gate = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gate * (i * xf)


def _combine(left, right):
    """The scan's operator: (a_l, b_l) then (a_r, b_r)."""
    (al, bl), (ar, br) = left, right
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even as long as odd or
    one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def _assoc_scan(elems):
    """Inclusive scan of (a, b) over axis 1 under :func:`_combine`: the
    recursion of ``jax.lax.associative_scan`` (combine adjacent pairs,
    scan the half, then fill in the even positions)."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:-1:2] for e in elems),
                       tuple(e[:, 1::2] for e in elems))
    odd = _assoc_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd),
                        tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def rglru_scan(p: Dict, x: torch.Tensor, h0: torch.Tensor = None):
    """The recurrence over a sequence. x: (B, S, W); h0: (B, W) carried
    state or None. Returns (h (B, S, W) in x's dtype, h_last (B, W) f32)."""
    a, b = _rglru_coeffs(p, x)
    if h0 is not None:
        # the carried state folds into the first step: h_1 = a_1 h_0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    _, h = _assoc_scan((a, b))
    return h.to(x.dtype), h[:, -1]


def _gelu_branch(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(matmul(x, p["in_gelu"]).float(), approximate="tanh")


def rglru_prefill(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  state: Dict = None) -> Tuple[torch.Tensor, Dict]:
    """The Griffin recurrent block over a sequence x (B, S, d) from
    ``state`` ({"h", "conv"}, or None: zeros). Returns (y (B, S, d), the
    state after the last position, padding included)."""
    g = _gelu_branch(p, x)
    u, conv = _conv1d(p, matmul(x, p["in_rnn"]),
                      None if state is None else state["conv"])
    h, h_last = rglru_scan(p, u, None if state is None else state["h"])
    y = (g * h.float()).to(x.dtype)
    return matmul(y, p["out"]), {"h": h_last, "conv": conv}


def rglru_block(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    """The block over a sequence from a zero state (forward, training)."""
    return rglru_prefill(cfg, p, x)[0]


def rglru_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One O(1) step. x: (B, 1, d); state: {"h": (B, W) f32, "conv":
    (B, K-1, W)}. Returns (y (B, 1, d), the new state)."""
    g = _gelu_branch(p, x)
    u, conv = _conv1d(p, matmul(x, p["in_rnn"]), state["conv"])
    a, b = _rglru_coeffs(p, u)
    h = a[:, 0] * state["h"].float() + b[:, 0]
    y = (g[:, 0] * h).to(x.dtype)[:, None]
    return matmul(y, p["out"]), {"h": h, "conv": conv}


def rglru_state_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict:
    w = cfg.lru_width_
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}
