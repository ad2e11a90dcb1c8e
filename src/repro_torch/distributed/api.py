"""Topology queries over ``torch.distributed``.

Counterpart of ``repro/distributed/api.py``'s :func:`process_topology`:
the reference asks JAX for its process index, count and local devices;
here the process group, when one is initialized, is whatever
``torch.distributed.init_process_group`` was given (any backend: the
group only supplies the rank and world size).
"""

from __future__ import annotations

from typing import Tuple


def process_topology() -> Tuple[int, int, int]:
    """``(host_index, n_hosts, n_local_devices)`` of this process.

    The sweep planner's default partition geometry
    (:func:`repro_torch.streamsim.plan.plan_sweep`): the rank and world
    size of the initialized ``torch.distributed`` group, else ``(0, 1)``;
    the local CUDA device count, or 1 (the host) without CUDA. Every
    process of a distributed run thus builds the same plan and executes
    only its strided slice of the grid.
    """
    import torch
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        pidx, pcount = dist.get_rank(), dist.get_world_size()
    else:
        pidx, pcount = 0, 1
    return pidx, pcount, max(torch.cuda.device_count(), 1)
