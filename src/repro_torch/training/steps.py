"""Step builders: the train, prefill and serve steps on one device.

Counterpart of the single-device part of ``repro/training/steps.py``. The
``jit_*`` makers return eager functions with the reference's signatures;
a ``mesh`` other than ``None`` raises ``NotImplementedError``: the
sharded steps come with the distribution slice of the port (A7 in
``ROADMAP.md``). ``policy`` and ``shard_seq`` only matter with a mesh.

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
taken as detached aliases that require grad, so the caller's tensors
never join a graph. ``donate`` keeps the reference's meaning: ``False``
leaves the inputs as they were, ``True`` lets the step update them in
place (the train step's parameters and optimizer state, the serve step's
cache), as the reference's donated buffers are reused.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as pytree
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (
    AdamW,
    adamw_update,
    adamw_update_in_place,
)


def value_and_grad(cfg: ModelConfig, params: Dict, batch: Dict
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Dict]:
    """``((loss, metrics), grads)`` of :func:`transformer.loss_fn`, the
    grads a tree of the parameters' layout and dtypes (zeros for a leaf
    the loss does not reach, as ``jax.grad`` gives)."""
    flat = pytree.leaves(params)
    live = [t.detach().requires_grad_() for t in flat]
    with torch.enable_grad():
        loss, metrics = transformer.loss_fn(
            cfg, pytree.unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), pytree.unflatten(params, grads)


def _train_step(cfg: ModelConfig, opt: AdamW, in_place: bool):
    update = adamw_update_in_place if in_place else adamw_update

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(cfg, params, batch)
        with torch.no_grad():
            params, opt_state, stats = update(opt, grads, opt_state, params)
        metrics = dict(metrics, **stats)
        return params, opt_state, metrics

    return train_step


def make_train_step(cfg: ModelConfig, opt: AdamW):
    """(params, opt_state, batch) -> (params, opt_state, metrics); the
    inputs are left as they were."""
    return _train_step(cfg, opt, in_place=False)


def make_forward_step(cfg: ModelConfig):
    """Inference forward (prefill shape): returns last-position logits and
    a cache of the prompt's length."""

    @torch.no_grad()
    def prefill_step(params, inputs, lengths):
        dev = params["embed"].device
        inputs = torch.as_tensor(inputs, device=dev)
        logits, cache = transformer.prefill(
            cfg, params, inputs, torch.as_tensor(lengths, device=dev),
            max_len=inputs.shape[1])
        return logits, cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode tick: (params, cache, tokens) -> (logits, cache). The
    cache is updated in place (the reference donates it at jit time)."""

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        return transformer.decode_step(
            cfg, params, cache,
            torch.as_tensor(tokens, device=params["embed"].device))

    return serve_step


# ------------------------------------------------------------- the makers
def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what} with a mesh: the sharded steps come with the "
            "distribution slice of the port (A7 in ROADMAP.md); pass "
            "mesh=None")


def jit_train_step(cfg: ModelConfig, opt: AdamW, mesh: Optional[Any] = None,
                   policy: str = "fsdp_tp", donate: bool = True,
                   shard_seq: bool = False):
    """The train step on the parameters' device. ``donate=True`` updates
    the parameters and the optimizer state in place and returns them."""
    _no_mesh(mesh, "jit_train_step")
    return _train_step(cfg, opt, in_place=donate)


def jit_serve_step(cfg: ModelConfig, mesh: Optional[Any] = None,
                   batch: int = 1, max_len: int = 0,
                   shard_seq: bool = True, donate: bool = True):
    """The serve step; with ``donate=False`` it works on a copy of the
    cache and leaves the caller's as it was."""
    _no_mesh(mesh, "jit_serve_step")
    step = make_serve_step(cfg)
    if donate:
        return step

    def serve_step(params, cache, tokens):
        return step(params, pytree.tree_map(torch.clone, cache), tokens)

    return serve_step


def jit_prefill_step(cfg: ModelConfig, mesh: Optional[Any] = None):
    _no_mesh(mesh, "jit_prefill_step")
    return make_forward_step(cfg)
