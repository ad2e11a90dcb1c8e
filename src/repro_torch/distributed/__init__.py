"""Distribution: the process topology the sweep planner partitions by.

Counterpart of ``repro.distributed``; its mesh and sharding rules are not
ported yet, only :func:`process_topology`.
"""

from repro_torch.distributed.api import process_topology  # noqa: F401
