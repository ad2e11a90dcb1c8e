"""AdamW from scratch: f32 moments, global-norm clipping, decoupled weight
decay, linear-warmup + cosine schedule.

Counterpart of ``repro/training/optimizer.py`` with the same dataclass
and the same state pytree, ``{"step": 0-dim int32, "m": tree f32,
"v": tree f32}``, on the parameters' device. The arithmetic follows the
reference op for op: the schedule, the bias corrections and the clip
scale are f32 tensors; the global norm is the Python sum of per-leaf f32
sums of squares in leaf order (:func:`repro_torch.tree.leaves`); each
leaf is cast to f32, updated and cast back to its dtype.

:func:`adamw_update` returns new tensors and leaves its inputs as they
were. :func:`adamw_update_in_place` does the same arithmetic and writes
the results into the parameters and the state, leaf by leaf: the
counterpart of the reference's buffer donation (``jit_train_step(...,
donate=True)``), which keeps one copy of the state on the device.

DTensor leaves (the sharded train step): each leaf is updated on its
local shard, the gradient first laid out as its parameter, so every new
leaf keeps its parameter's placements and the arithmetic is the same
element by element. The global norm gathers one gradient leaf at a time
and sums it whole, as on one device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch import tree as pytree
from repro_torch.distributed import layout


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Any) -> Dict:
    leaves = pytree.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    zeros = lambda p: (torch.zeros_like(p, dtype=torch.float32)
                       if isinstance(p, DTensor) else
                       torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device))
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": pytree.tree_map(zeros, params),
        "v": pytree.tree_map(zeros, params),
    }


def _schedule(cfg: AdamW, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    sums = [torch.sum(torch.square(layout.whole(x).to(torch.float32)))
            for x in pytree.leaves(tree)]
    return torch.sqrt(sum(sums))


def adamw_update(cfg: AdamW, grads: Any, state: Dict, params: Any
                 ) -> Tuple[Any, Dict, Dict]:
    """Returns (new_params, new_state, stats)."""
    return _update(cfg, grads, state, params, in_place=False)


def adamw_update_in_place(cfg: AdamW, grads: Any, state: Dict, params: Any
                          ) -> Tuple[Any, Dict, Dict]:
    """:func:`adamw_update` written into ``params`` and ``state``, which
    it returns with the stats."""
    return _update(cfg, grads, state, params, in_place=True)


def _update(cfg: AdamW, grads: Any, state: Dict, params: Any,
            in_place: bool) -> Tuple[Any, Dict, Dict]:
    step = layout.local(state["step"]) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = _schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v):
        if isinstance(p, DTensor):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            p, g, m, v = p.to_local(), g.to_local(), m.to_local(), \
                v.to_local()
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(
            torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    flat_p = pytree.leaves(params)
    flat = zip(flat_p, pytree.leaves(grads), pytree.leaves(state["m"]),
               pytree.leaves(state["v"]))
    if in_place:
        for p, g, m, v in flat:
            new = upd(p, g, m, v)
            for dst, src in zip((p, m, v), new):
                layout.local(dst).copy_(src)
            del new
        layout.local(state["step"]).copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}
    flat = list(flat)
    out = [upd(p, g, m, v) for p, g, m, v in flat]
    new_p = pytree.unflatten(params, [layout.like(f[0], o[0])
                                      for f, o in zip(flat, out)])
    new_m = pytree.unflatten(params, [layout.like(f[2], o[1])
                                      for f, o in zip(flat, out)])
    new_v = pytree.unflatten(params, [layout.like(f[3], o[2])
                                      for f, o in zip(flat, out)])
    stats = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"step": layout.like(state["step"], step), "m": new_m,
                   "v": new_v}, stats
