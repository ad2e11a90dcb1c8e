"""Gradient compression for the DP all-reduce: int8 quantization with
error feedback (1-bit-Adam-family trick, int8 variant).

Counterpart of ``repro/distributed/compression.py``. The reference wraps
the data-parallel gradient exchange in ``shard_map`` and reduces
quantized tensors with ``psum``; here each rank computes its gradient
eagerly and the exchange is an explicit ``torch.distributed`` collective
over the group of one mesh dim (``mesh.get_group(axis)``). Error feedback
carries the quantization residual into the next step, which keeps
convergence.

Wire format per leaf: int8 values + per-leaf f32 scale (amax / 127).
Reduction: the scale's max over the group (``all_reduce(MAX)``), the
values rescaled to it as an int32 payload (no overflow below 2^23
ranks) summed by ``all_reduce(SUM)``, then dequantized by the max scale.
``quantize``, ``dequantize`` and the reduction's arithmetic are the
reference's as XLA compiles them on the CPU (the reference runs them
under ``jit``), bit for bit: ``torch.round`` rounds half to even, as
``jnp.round``; ``amax / 127`` is a product by the f32 reciprocal and the
residual ``gc - q * scale`` is rounded once, as XLA rewrites and
contracts them.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as pytree

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "compression_mesh", default=None)


@contextlib.contextmanager
def collective_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the one whose dims :func:`compressed_psum` names (the
    counterpart of running inside the reference's ``shard_map``)."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"not a DeviceMesh: {type(mesh).__name__}")
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # amax / 127 as the reference computes it under jit: XLA turns the
    # division by the constant into a product by its f32 reciprocal
    scale = torch.max(torch.abs(g)).to(torch.float32) * (1.0 / 127.0)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _group(axis: str):
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("compressed_psum outside collective_mesh(...) or "
                           "make_compressed_dp_grad: no mesh names "
                           f"{axis!r}")
    return mesh.get_group(axis)


def compressed_psum(g: torch.Tensor, axis: str, ef: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-reduce-mean of g over the mesh dim ``axis`` with int8 wire
    format.

    ef: error-feedback residual from the previous step (same shape as g).
    Returns (mean gradient, new residual)."""
    group = _group(axis)
    n = float(dist.get_world_size(group))
    gc = g.to(torch.float32) + ef
    q, scale = quantize(gc)
    sent = dequantize(q, scale)
    # gc - q * scale rounded once, as XLA contracts it on the CPU (a fused
    # multiply-subtract); exact in f64: the int8 x f32 product has 32
    # significant bits and lies within scale / 2 of gc
    new_ef = (gc.double() - q.double() * scale.double()).to(torch.float32)
    # shared scale: use the max over shards so the int32 sum is consistent
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q_rescaled = torch.clamp(torch.round(sent / smax), -127, 127
                             ).to(torch.int32)
    dist.all_reduce(q_rescaled, op=dist.ReduceOp.SUM, group=group)
    return q_rescaled.to(torch.float32) * smax / n, new_ef


def _value_and_grad(loss_fn: Callable, params: Any, batch: Any):
    flat = pytree.leaves(params)
    live = [t.detach().requires_grad_() for t in flat]
    with torch.enable_grad():
        loss = loss_fn(pytree.unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    return loss.detach(), grads


def make_compressed_dp_grad(loss_fn, mesh: DeviceMesh, axis: str = "data"):
    """Build grad_fn(params, batch, ef) -> (loss, grads, new_ef) where the
    per-shard gradients reduce over `axis` in int8.

    ``params`` and ``ef`` are replicated (the same plain tensors on every
    rank); ``batch`` is ``{"inputs", "labels"}`` of the global batch, of
    which each rank takes its rows along ``axis`` (the reference's
    ``P(axis, None)``). The loss is the mean over the group."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"not a DeviceMesh: {type(mesh).__name__}")
    group = mesh.get_group(axis)
    n, me = dist.get_world_size(group), mesh.get_local_rank(axis)

    def rows(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows over {n} ranks "
                             f"of {axis!r}")
        b = x.shape[0] // n
        return x[me * b:(me + 1) * b]

    def grad_fn(params, batch, ef):
        local = {k: rows(v) for k, v in batch.items()}
        loss, flat_g = _value_and_grad(loss_fn, params, local)
        loss = loss.to(torch.float32).clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / n
        red, new_e = [], []
        with collective_mesh(mesh), torch.no_grad():
            for g, e in zip(flat_g, pytree.leaves(ef)):
                r, ne = compressed_psum(g, axis, e)
                red.append(r.to(g.dtype))
                new_e.append(ne)
        return (loss, pytree.unflatten(params, red),
                pytree.unflatten(params, new_e))

    return grad_fn


def ef_init(params: Any) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32,
                              device=p.device), params)
