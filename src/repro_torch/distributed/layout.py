"""FSDP-style storage by the reference's tables: trees of DTensors placed on
a mesh, gathered a layer at a time for compute.

The sharded steps of :mod:`repro_torch.training.steps` keep parameters,
optimizer moments, batches and caches as DTensors in the layouts of
:mod:`repro_torch.distributed.sharding`. Compute runs the single-device
model code on plain tensors:

- :func:`gather` turns a layer's DTensor leaves into whole tensors just
  before the layer (``full_tensor``), with the gradient coming back in
  the leaf's layout: averaged over the data-parallel mesh dims
  (``Partial("avg")``: each DP rank's loss is the mean over its own rows,
  and the step's loss is their mean) and taken as replicated over the
  others (every ``model`` rank computes the same rows);
- :func:`layer_cache` / :func:`write_layer_cache` gather one layer of a
  stacked decode cache over every mesh dim but its batch rows, and write
  this rank's slice of the updated layer back;
- :func:`dp_rows` hands a layer that mixes rows (the MoE's capacity and
  load-balance statistics) every DP rank's rows, so it computes the
  function of the global batch, as the reference's SPMD program does.

A plain tensor passes through each of these unchanged, so the steps
without a mesh run the code of one device as it is.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from repro_torch import tree as pytree
from repro_torch.distributed.api import active_rules
from repro_torch.distributed.sharding import DP_AXES, NamedSharding


def is_sharded(x) -> bool:
    return isinstance(x, DTensor)


def local(x):
    """This rank's local tensor of a DTensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def whole(x):
    """A DTensor gathered whole; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def like(ref, t: torch.Tensor):
    """``t``, a local tensor, in the layout of ``ref`` where ``ref`` is a
    DTensor; else ``t``."""
    if not isinstance(ref, DTensor):
        return t
    return DTensor.from_local(t, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def _dp_names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(n for n in mesh.mesh_dim_names if n in DP_AXES)


def grad_placements(mesh: DeviceMesh):
    """The layout a gathered leaf's gradient comes back in: averaged over
    the DP mesh dims, replicated over the others."""
    return [Partial("avg") if n in DP_AXES else Replicate()
            for n in mesh.mesh_dim_names]


def gather(tree: Any) -> Any:
    """``tree`` with every DTensor leaf gathered whole (differentiable:
    the gradient comes back in the leaf's layout, :func:`grad_placements`);
    plain leaves as they are."""
    flat = pytree.leaves(tree)
    if not any(isinstance(t, DTensor) for t in flat):
        return tree
    return pytree.unflatten(tree, [
        t.full_tensor(grad_placements=grad_placements(t.device_mesh))
        if isinstance(t, DTensor) else t for t in flat])


def place(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` laid out by the matching
    :class:`~repro_torch.distributed.sharding.NamedSharding`: a plain
    tensor is cut into this rank's slice (every rank holds the same value,
    as ``jit`` assumes of a host array; nothing is sent), a DTensor is
    redistributed where its layout differs."""
    flat, shard = pytree.leaves(tree), pytree.leaves(shardings)
    if len(flat) != len(shard):
        raise ValueError(f"{len(shard)} shardings for {len(flat)} leaves")
    out = []
    for t, sh in zip(flat, shard):
        if not isinstance(sh, NamedSharding):
            raise TypeError(f"not a NamedSharding: {type(sh).__name__}")
        want = sh.placements
        if isinstance(t, DTensor):
            out.append(t if tuple(t.placements) == want else
                       t.redistribute(sh.mesh, want))
        else:             # a copy: an in-place step must not reach t
            d = distribute_tensor(torch.as_tensor(t).to(sh.mesh.device_type),
                                  sh.mesh, want, src_data_rank=None)
            out.append(like(d, d.to_local().clone()))
    if all(a is b for a, b in zip(out, flat)):
        return tree                   # as given: a donated step keeps it
    return pytree.unflatten(tree, out)


def own_slice(t: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's slice of the whole tensor ``t`` under ``placements``
    (DTensor's split: each ``Shard(d)``, in mesh-dim order, cuts dim ``d``
    as ``torch.chunk`` does, an empty slice past the last chunk)."""
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, k = mesh.size(m), mesh.get_local_rank(m)
            chunks = torch.chunk(t, n, dim=p.dim)
            t = chunks[k] if k < len(chunks) else t.narrow(p.dim, 0, 0)
    return t


def from_rows(x: torch.Tensor, mesh: DeviceMesh, batch_sharded: bool,
              dim: int = 0) -> DTensor:
    """This rank's rows ``x`` (its batch axis ``dim``) as the global
    DTensor: that axis sharded over the DP mesh dims when
    ``batch_sharded`` (replicated otherwise), every other mesh dim
    replicated."""
    pl = [Shard(dim) if batch_sharded and n in DP_AXES else Replicate()
          for n in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, pl, run_check=False)


def dp_size(mesh: DeviceMesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(n)) for n in _dp_names(mesh))


def dp_mean(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The mean over the DP ranks of a per-rank scalar, summed in rank
    order (the same value on every rank); itself on one DP rank."""
    n = dp_size(mesh)
    if n == 1:
        return t
    vals = from_rows(t.reshape(1), mesh, True).full_tensor()
    return vals.sum() / n


# ------------------------------------------------------------------- cache
def _gathered(lt: DTensor):
    """A layer's placements with only its batch axis (0) kept sharded."""
    return [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lt.placements]


def layer_cache(stacked: Dict, i: int) -> Dict:
    """Layer ``i`` of a run's stacked DTensor cache, each leaf gathered
    over every mesh dim but its batch rows' (plain tensors with a leading
    axis of 1, this rank's rows)."""
    out = {}
    for k, t in stacked.items():
        lt = t[i]
        out[k] = lt.redistribute(lt.device_mesh, _gathered(lt)
                                 ).to_local()[None]
    return out


def write_layer_cache(stacked: Dict, i: int, lc: Dict) -> None:
    """This rank's slice of the updated layer ``lc`` (from
    :func:`layer_cache`) written into layer ``i`` of the stacked cache."""
    for k, t in stacked.items():
        lt = t[i]
        whole = DTensor.from_local(lc[k][0], lt.device_mesh, _gathered(lt),
                                   run_check=False, shape=lt.shape,
                                   stride=lt.stride())
        mine = whole.redistribute(lt.device_mesh, lt.placements).to_local()
        t.to_local()[i].copy_(mine)


# -------------------------------------------------------------------- rows
def dp_rows(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """``(rows of every DP rank, first, end)``: under rules whose
    ``batch`` names DP mesh dims of more than one rank, this rank's rows
    ``x`` gathered with the other DP ranks' (in the global batch's order)
    and where its own lie; else ``(x, 0, len(x))``. Differentiable: each
    rank's gradient with respect to the gathered rows is summed back onto
    the rows' owner."""
    ctx = active_rules()
    if ctx is None:
        return x, 0, x.shape[0]
    mesh, rules = ctx
    batch = rules.get("batch")
    if not isinstance(mesh, DeviceMesh) or batch is None:
        return x, 0, x.shape[0]
    names = mesh.mesh_dim_names
    dp = batch if isinstance(batch, tuple) else (batch,)
    if math.prod(mesh.size(names.index(n)) for n in dp) == 1:
        return x, 0, x.shape[0]
    pl = [Shard(0) if n in dp else Replicate() for n in names]
    grads = [Partial("sum") if n in dp else Replicate() for n in names]
    whole = DTensor.from_local(x, mesh, pl, run_check=False).full_tensor(
        grad_placements=grads)
    idx = 0
    for n in dp:                                     # major to minor
        idx = idx * mesh.size(names.index(n)) + mesh.get_local_rank(n)
    b = x.shape[0]
    return whole, idx * b, (idx + 1) * b
