"""Step builders: the train, prefill and serve steps, on one device or
placed on a mesh by the reference's spec tables.

Counterpart of ``repro/training/steps.py``. The ``jit_*`` makers return
eager functions with the reference's signatures. Without a mesh they run
on the parameters' device. With a mesh (a ``DeviceMesh`` whose dims are
named ``pod``/``data``/``model``) every input is laid out as the
reference's ``in_shardings`` say and every output comes back in those
layouts (:mod:`repro_torch.distributed.sharding`): parameters by
``param_pspecs(policy)`` (``"tp"`` for serving), the AdamW state as
``{"step": P(), "m": pspec, "v": pspec}``, batches by ``batch_pspec``,
caches by ``cache_pspecs(shard_seq)``, decode tokens by ``P(dp)`` where
the batch divides the DP size, else replicated. A plain tensor given to
a sharded step is laid out by the step (each rank keeps its slice of the
same value, as ``jit`` places a host array); DTensors in another layout
are redistributed. The metrics come back replicated, the same plain
tensors on every rank; logits as DTensors sharded by rows over DP.

Compute is FSDP-style (:mod:`repro_torch.distributed.layout`): each DP
rank (``pod`` x ``data``) computes its own batch rows, the ranks along
``model`` the same rows; a layer's parameters are gathered whole just
before the layer, and their gradients come back averaged over DP in
the parameters' layout. The serve step gathers each layer's cache over
``model`` for the rank's rows, decodes with the kernels on local tensors
and keeps its own slice of the updated layer. A sharded step never runs
the unsharded one in its place.

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

from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as pytree
from repro_torch.distributed import layout
from repro_torch.distributed.api import sharding_rules
from repro_torch.distributed.sharding import (
    P,
    activation_rules,
    batch_pspec,
    cache_pspecs,
    dp_axes,
    named,
    param_pspecs,
)
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
def _check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names is None:
        raise TypeError(f"mesh must be a DeviceMesh with named dims "
                        f"(launch.mesh.make_host_mesh), not "
                        f"{type(mesh).__name__}")
    if mesh.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh but torch.cuda.is_available() is "
                           "False; build the mesh with device='cpu'")
    return mesh


def _rows(x, mesh: DeviceMesh, what: str):
    """``x``'s global batch must split evenly over the DP ranks."""
    n = layout.dp_size(mesh)
    if x.shape[0] % n:
        raise ValueError(f"{what}: a batch of {x.shape[0]} rows does not "
                         f"split over {n} data-parallel ranks")


def _train_specs(cfg: ModelConfig, mesh: DeviceMesh, policy: str):
    """(params, AdamW state, batch) spec trees of the sharded train step."""
    pspec = param_pspecs(cfg, mesh, transformer.param_specs(cfg), policy)
    bp = batch_pspec(mesh)
    bspec = {"inputs": bp["tokens"] if cfg.input_mode == "tokens"
             else bp["embeds"],
             "labels": bp["labels"]}
    return pspec, {"step": P(), "m": pspec, "v": pspec}, bspec


def sharded_value_and_grad(cfg: ModelConfig, mesh, policy: str = "fsdp_tp",
                           shard_seq: bool = False):
    """The gradient of the sharded train step: ``fn(params, batch) ->
    ((loss, metrics), grads, params)`` with ``params`` and ``batch`` laid
    out as the step lays them out (returned placed), the loss and metrics
    the means over the DP ranks (replicated), ``grads`` DTensors in the
    parameters' layouts."""
    _check_mesh(mesh)
    pspec, _, bspec = _train_specs(cfg, mesh, policy)
    rules = activation_rules(mesh, shard_seq=shard_seq)

    def fn(params, batch):
        if set(batch) != set(bspec):
            raise ValueError(f"batch keys {sorted(batch)}, the sharded "
                             f"step takes {sorted(bspec)}")
        _rows(batch["inputs"], mesh, "the sharded train step")
        params = layout.place(params, named(mesh, pspec))
        batch = layout.place(batch, named(mesh, bspec))
        rows = {k: layout.local(v) for k, v in batch.items()}
        with sharding_rules(mesh, rules):
            (loss, metrics), grads = value_and_grad(cfg, params, rows)
        metrics = {k: layout.dp_mean(v, mesh) for k, v in metrics.items()}
        return (metrics["loss"], metrics), grads, params

    return fn


def jit_train_step(cfg: ModelConfig, opt: AdamW, mesh: Optional[Any] = None,
                   policy: str = "fsdp_tp", donate: bool = True,
                   shard_seq: bool = False):
    """The train step. ``donate=True`` updates the parameters and the
    optimizer state in place and returns them. With a mesh: the sharded
    step (module docstring); a batch is ``{"inputs", "labels"}``."""
    if mesh is None:
        return _train_step(cfg, opt, in_place=donate)
    grad_fn = sharded_value_and_grad(cfg, mesh, policy, shard_seq)
    _, ospec, _ = _train_specs(cfg, mesh, policy)
    update = adamw_update_in_place if donate else adamw_update

    def train_step(params, opt_state, batch):
        (_, metrics), grads, params = grad_fn(params, batch)
        opt_state = layout.place(opt_state, named(mesh, ospec))
        with torch.no_grad():
            params, opt_state, stats = update(opt, grads, opt_state, params)
        return params, opt_state, dict(metrics, **stats)

    return train_step


def _token_spec(cfg: ModelConfig, dp) -> P:
    return P(dp) if cfg.input_mode == "tokens" else P(dp, None)


def jit_serve_step(cfg: ModelConfig, mesh: Optional[Any] = None,
                   batch: int = 1, max_len: int = 0,
                   shard_seq: bool = True, donate: bool = True):
    """The serve step; with ``donate=False`` it works on a copy of the
    cache and leaves the caller's as it was. With a mesh: the sharded
    step for a cache of ``batch`` sequences of ``max_len`` positions."""
    step = make_serve_step(cfg)
    if mesh is None:
        if donate:
            return step

        def serve_step(params, cache, tokens):
            return step(params, pytree.tree_map(torch.clone, cache), tokens)

        return serve_step
    _check_mesh(mesh)
    pspec = param_pspecs(cfg, mesh, transformer.param_specs(cfg), "tp")
    cspec = cache_pspecs(cfg, mesh, transformer.init_cache(
        cfg, batch, max_len, device="meta"), shard_seq=shard_seq)
    dp = dp_axes(mesh)
    dp = dp if batch % layout.dp_size(mesh) == 0 else None
    rules = activation_rules(mesh)
    if dp is None:           # the rows are replicated, not split over DP
        rules["batch"] = None

    @torch.no_grad()
    def serve_step(params, cache, tokens):
        if not donate:
            cache = pytree.tree_map(torch.clone, cache)
        params = layout.place(params, named(mesh, pspec))
        cache = layout.place(cache, named(mesh, cspec))
        tokens = layout.place(tokens, named(mesh, _token_spec(cfg, dp)))
        with sharding_rules(mesh, rules):
            logits, cache = transformer.decode_step(
                cfg, params, cache, layout.local(tokens))
        return layout.from_rows(logits, mesh, dp is not None), cache

    return serve_step


def jit_prefill_step(cfg: ModelConfig, mesh: Optional[Any] = None):
    """The prefill step: last-position logits and a cache of the prompts'
    length. With a mesh, the cache comes back in ``cache_pspecs``'s
    layout (``shard_seq`` on, the serve step's default)."""
    if mesh is None:
        return make_forward_step(cfg)
    _check_mesh(mesh)
    pspec = param_pspecs(cfg, mesh, transformer.param_specs(cfg), "tp")
    dp = dp_axes(mesh)
    ispec = P(dp, None) if cfg.input_mode == "tokens" else P(dp, None, None)
    rules = activation_rules(mesh)

    @torch.no_grad()
    def prefill_step(params, inputs, lengths):
        _rows(inputs, mesh, "jit_prefill_step")
        params = layout.place(params, named(mesh, pspec))
        inputs = layout.place(inputs, named(mesh, ispec))
        lengths = layout.place(lengths, named(mesh, P(dp)))
        b, s = inputs.shape[0], inputs.shape[1]
        with sharding_rules(mesh, rules):
            logits, cache = transformer.prefill(
                cfg, params, layout.local(inputs), layout.local(lengths),
                max_len=s)
        cspec = cache_pspecs(cfg, mesh, transformer.init_cache(
            cfg, b, s, device="meta"))
        cache = {"runs": [{k: layout.from_rows(v, mesh, True, dim=1)
                           for k, v in run.items()}
                          for run in cache["runs"]],
                 "pos": layout.from_rows(cache["pos"], mesh, True)}
        return (layout.from_rows(logits, mesh, True),
                layout.place(cache, named(mesh, cspec)))

    return prefill_step
