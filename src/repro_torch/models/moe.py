"""Mixture of experts with capacity dispatch (llama4-scout, deepseek-v3).

Counterpart of ``repro/models/moe.py``, with the same parameter layout
(router (d, E) f32; experts gate/up (E, d, F), down (E, F, d); an
optional shared SwiGLU of width ``n_shared_experts * F``) and the same
rules:

- the router scores by softmax (renormalised top-k) or by sigmoid
  (DeepSeek-V3, Llama 4); its top-k breaks ties toward the lower expert
  id, as ``lax.top_k`` does (a stable descending sort, then the first k);
  the Switch load-balance loss and the router z-loss come back as aux;
- capacity: dropless (``cap = T``) while ``T * k <= 4096`` (decode
  steps, short prefills), else ``max(int(T * k / E * capacity_factor),
  1)`` slots an expert; an assignment's slot is its rank among the same
  expert's assignments in assignment order (an exclusive cumsum), and an
  assignment at or past ``cap`` is dropped (the residual carries its
  token);
- the (E, C, d) buffer is gathered through a slot -> token map whose
  trash row (token T, zeros) fills the empty slots, the experts run as
  E-batched products with the gate and up products kept in f32, and the
  results come back weighted by the gates in the compute dtype.

The combine is the reference's scatter-add into zeros, taken in its
order without atomics: each token adds its contributions in ascending
expert id, starting from zero, which is the order of an in-order scatter
over the flattened (E, C) buffer. (``index_add_`` on the card adds with
atomics in an order that changes from run to run, so in bf16 a greedy
token could change between runs.)

The reference's sharding constraints (``constrain``) stand at its
points; on the local tensors of a sharded step they are the identity.
Capacity and the load-balance statistics depend on every token of the
batch, so under the sharded steps' rules the block runs on the rows of
every data-parallel rank (:func:`repro_torch.distributed.layout.dp_rows`)
and returns this rank's: the function of the global batch, as the
reference's SPMD program computes it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import layout
from repro_torch.distributed.api import constrain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init

#: the largest T * k routed without capacity (every expert gets T slots)
DROPLESS_ASSIGNMENTS = 4096


def _expert_weights(gen: torch.Generator, e: int, d_in: int, d_out: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """(E, d_in, d_out) N(0, 1/d_in) weights, drawn an expert at a time
    (the reference draws one (d_in, E * d_out) matrix, whose f32 draw at
    deepseek-v3's width would be 15 GB at once)."""
    w = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
    for i in range(e):
        w[i] = dense_init(gen, d_in, d_out, dtype)
    return w


def moe_init(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    dt = getattr(torch, cfg.dtype)
    p = {"router": dense_init(gen, d, e, torch.float32),
         "experts": {"gate": _expert_weights(gen, e, d, f, dt),
                     "up": _expert_weights(gen, e, d, f, dt),
                     "down": _expert_weights(gen, e, f, d, dt)}}
    if cfg.n_shared_experts > 0:
        p["shared"] = swiglu_init(gen, d, cfg.n_shared_experts * f, dt)
    return p


def top_k(scores: torch.Tensor, k: int):
    """``(values, ids)`` of the k largest scores of each row, ties to the
    lower id (``lax.top_k``'s order)."""
    vals, ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _router(cfg: ModelConfig, p: Dict, x2: torch.Tensor):
    """x2: (T, d) -> (gates (T, k) f32, ids (T, k), aux losses)."""
    logits = torch.matmul(x2.float(), p["router"])
    if cfg.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
        gates, ids = top_k(scores, cfg.top_k)
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, ids = top_k(probs, cfg.top_k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # Switch load-balance loss and router z-loss
    e = cfg.n_experts
    me = F.one_hot(ids[:, 0], e).float().mean(0)
    lb_loss = e * torch.sum(me * probs.mean(0))
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, ids, {"moe_lb": lb_loss, "moe_z": z_loss}


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens."""
    if t * cfg.top_k <= DROPLESS_ASSIGNMENTS:
        return t
    return max(int(t * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)


def slots(ids: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """Each assignment's slot in its expert's buffer, (T * k,): its rank
    among the same expert's assignments in assignment order, or ``cap``
    (the trash slot) where that rank is ``cap`` or more."""
    flat = ids.reshape(-1)
    onehot = F.one_hot(flat, e)
    ranks = torch.cumsum(onehot, dim=0) - onehot                 # exclusive
    rank = torch.gather(ranks, 1, flat[:, None])[:, 0]
    return torch.where(rank >= cap, torch.full_like(rank, cap), rank)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, f32 out (f32 accumulation of the operands' exact
    products, the reference's ``preferred_element_type``)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def moe_block(cfg: ModelConfig, p: Dict, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, aux losses)."""
    x, lo, hi = layout.dp_rows(x)
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    x2 = x.reshape(t, d)
    gates, ids, aux = _router(cfg, p, x2)
    cap = capacity(cfg, t)
    flat_ids = ids.reshape(-1)
    slot = slots(ids, e, cap)

    # dispatch: gather the (E, C, d) buffer through the slot -> token map
    tok_of_assign = torch.arange(t, device=x.device).repeat_interleave(k)
    tok_map = torch.full((e, cap + 1), t, dtype=torch.long, device=x.device)
    tok_map[flat_ids, slot] = tok_of_assign        # column cap: the trash
    x_pad = torch.cat([x2, x2.new_zeros((1, d))])
    buf = x_pad[tok_map[:, :cap]]                                # (E, C, d)
    buf = constrain(buf, "expert", None, None)

    w = p["experts"]
    g = _bmm_f32(buf, w["gate"])
    u = _bmm_f32(buf, w["up"])
    h = (F.silu(g) * u).to(x.dtype)
    out_buf = torch.bmm(h, w["down"]).to(x.dtype)
    out_buf = constrain(out_buf, "expert", None, None)

    # combine: each token's contributions in ascending expert id, from 0
    order = torch.argsort(ids, dim=1)
    ids_s = torch.gather(ids, 1, order)
    slot_s = torch.gather(slot.reshape(t, k), 1, order)
    gate_s = torch.gather(gates, 1, order).to(x.dtype)
    kept = slot_s < cap
    rows = out_buf[ids_s, torch.clamp(slot_s, max=cap - 1)]    # (T, k, d)
    contrib = torch.where(kept[..., None], rows * gate_s[..., None],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        y = y + contrib[:, j]
    y = constrain(y, "batch", None)

    if "shared" in p:
        y = y + swiglu(p["shared"], x2)
    return y.reshape(b, s, d)[lo:hi], aux
