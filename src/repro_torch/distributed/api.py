"""Logical-axis sharding constraints and the process topology.

Counterpart of ``repro/distributed/api.py``. Model code annotates
activations with *logical* axis names::

    x = constrain(x, "batch", "seq", "embed")

Outside :func:`sharding_rules` this is the identity, so models stay
runnable on one device. Inside, the names map to mesh axes: a DTensor is
redistributed to the rule's placements (its values unchanged), and a
plain tensor, which is one rank's local rows in the sharded steps of
:mod:`repro_torch.training.steps`, comes back as it was.

:func:`process_topology` reads the initialized ``torch.distributed``
group (any backend: the group only supplies the rank and world size).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import P, placements

_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "sharding_rules", default=None)


@contextlib.contextmanager
def sharding_rules(mesh, rules: Dict[str, Optional[object]]):
    """Activate logical->mesh axis rules, e.g.
    {'batch': ('pod', 'data'), 'embed': None, 'heads': 'model'}."""
    token = _RULES.set((mesh, dict(rules)))
    try:
        yield
    finally:
        _RULES.reset(token)


def active_rules() -> Optional[Tuple[object, Dict]]:
    return _RULES.get()


def process_topology() -> Tuple[int, int, int]:
    """``(host_index, n_hosts, n_local_devices)`` of this process.

    The sweep planner's default partition geometry
    (:func:`repro_torch.streamsim.plan.plan_sweep`): the rank and world
    size of the initialized ``torch.distributed`` group, else ``(0, 1)``;
    the local CUDA device count, or 1 (the host) without CUDA. Every
    process of a distributed run thus builds the same plan and executes
    only its strided slice of the grid.
    """
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        pidx, pcount = dist.get_rank(), dist.get_world_size()
    else:
        pidx, pcount = 0, 1
    return pidx, pcount, max(torch.cuda.device_count(), 1)


def constrain(x, *logical_axes: Optional[str]):
    """Annotate x (rank == len(logical_axes)) with the active rules: a
    DTensor is redistributed to the rules' placements; a plain (local)
    tensor, and a tensor of another rank, come back as they were."""
    ctx = _RULES.get()
    if ctx is None:
        return x
    mesh, rules = ctx
    if x.ndim != len(logical_axes):
        return x  # shape changed; skip rather than mis-pin
    if not isinstance(x, DTensor):
        return x
    spec = P(*[rules.get(a) if a is not None else None
               for a in logical_axes])
    mesh = mesh if isinstance(mesh, DeviceMesh) else x.device_mesh
    return x.redistribute(mesh, placements(mesh, spec))
