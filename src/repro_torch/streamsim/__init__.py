"""Stream-data simulation substrate (the paper's contribution), ported.

Pipeline stages (paper Fig. 4):
  POSD  -> :mod:`repro_torch.streamsim.preprocess`
  NSSD  -> :mod:`repro_torch.streamsim.nsa`         (Algorithm 1)
  PSD   -> :mod:`repro_torch.streamsim.producer`    (Algorithm 2)

Supporting pieces: synthetic datasets, the stream store ("database"), the
Kafka-analogue bounded queue, volatility metrics, the sweep plan and
engine, and the controller.
"""

from repro_torch.streamsim.datasets import (  # noqa: F401
    DATASETS,
    make_stream,
    sogouq,
    traffic,
    userbehavior,
)
from repro_torch.streamsim.preprocess import Stream, preprocess  # noqa: F401
from repro_torch.streamsim.nsa import (  # noqa: F401
    nsa,
    nsa_paper,
    scale_stamps,
)
from repro_torch.streamsim.metrics import (  # noqa: F401
    StreamMetrics,
    Volatility,
    metrics_batched,
    per_second_counts,
    volatility,
)
from repro_torch.streamsim.store import StreamStore  # noqa: F401
from repro_torch.streamsim.queue import (  # noqa: F401
    ByteBudget,
    StreamQueue,
)
from repro_torch.streamsim.faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedConsumerCrash,
)
from repro_torch.streamsim.producer import (  # noqa: F401
    Producer,
    RealClock,
    VirtualClock,
)
from repro_torch.streamsim.plan import (  # noqa: F401
    ScenarioSpec,
    Shard,
    SweepPlan,
    plan_sweep,
)
from repro_torch.streamsim.engine import (  # noqa: F401
    DeviceSweepResult,
    SimulationReport,
    execute_sweep,
)
from repro_torch.streamsim.controller import Controller  # noqa: F401
