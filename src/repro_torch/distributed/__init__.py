"""Distribution: the logical-axis sharding rules and their placements on a
``DeviceMesh``, the constraint API the model code calls (the identity
outside an active rules context), the FSDP-style storage of the sharded
steps (:mod:`repro_torch.distributed.layout`), int8 gradient compression
(:mod:`repro_torch.distributed.compression`) and the process topology
the sweep planner partitions by.

Counterpart of ``repro.distributed``; meshes come from
:mod:`repro_torch.launch.mesh`.
"""

from repro_torch.distributed.api import (  # noqa: F401
    active_rules,
    constrain,
    process_topology,
    sharding_rules,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    RULESETS,
    NamedSharding,
    P,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
)
