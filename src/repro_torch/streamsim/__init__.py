"""Stream-data simulation substrate (the paper's contribution), ported.

Pipeline stages (paper Fig. 4):
  POSD  -> :mod:`repro_torch.streamsim.preprocess`
  NSSD  -> :mod:`repro_torch.streamsim.nsa`         (Algorithm 1)
  PSD   -> :mod:`repro_torch.streamsim.producer`    (Algorithm 2)

Supporting pieces: synthetic datasets, the stream store ("database"), the
Kafka-analogue bounded queues, volatility and trend metrics, the sweep plan
and engine, the controller, the lease-based sweep service
(:mod:`repro_torch.streamsim.service`), seeded fault injection
(:mod:`repro_torch.streamsim.faults`) and the retry/breaker/deadline
primitives (:mod:`repro_torch.streamsim.resilience`), the stream tasks
(:mod:`repro_torch.streamsim.tasks`) and the paper's task benchmark
(:mod:`repro_torch.streamsim.taskbench`).
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
    ChunkedNSA,
    ChunkHandles,
    nsa,
    nsa_batched,
    nsa_paper,
    nsa_sweep,
    scale_stamps,
)
from repro_torch.streamsim.metrics import (  # noqa: F401
    StreamMetrics,
    Volatility,
    metrics_batched,
    per_second_counts,
    trend,
    trend_correlation,
    trend_correlation_matrix,
    volatility,
)
from repro_torch.streamsim.store import StreamStore  # noqa: F401
from repro_torch.streamsim.queue import (  # noqa: F401
    ByteBudget,
    QueueGroup,
    StreamQueue,
)
from repro_torch.streamsim.faults import (  # noqa: F401
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedConsumerCrash,
)
from repro_torch.streamsim.resilience import (  # noqa: F401
    BreakerOpen,
    CircuitBreaker,
    Deadline,
    Heartbeat,
    Lease,
    RetryPolicy,
    SweepCheckpoint,
)
from repro_torch.streamsim.producer import (  # noqa: F401
    ChunkFeed,
    MultiQueueProducer,
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
    ChunkedSweepRunner,
    DeviceSweepResult,
    FidelityReport,
    SimulationReport,
    consumer_label,
    execute_sweep,
    run_sweep,
    run_sweep_chunked,
)
from repro_torch.streamsim.controller import Controller  # noqa: F401
from repro_torch.streamsim.service import (  # noqa: F401
    SweepService,
    merge_fidelity,
    pack_counts,
    run_service_sweep,
    unpack_counts,
)
from repro_torch.streamsim.tasks import (  # noqa: F401
    LATENCY_BIN_US,
    LATENCY_BINS,
    BucketTask,
    ETLTask,
    EventDetectTask,
    ServingTask,
    StreamTask,
    WindowedStatsTask,
    output_series,
)
from repro_torch.streamsim.taskbench import (  # noqa: F401
    FIDELITY_FLOOR,
    PAPER_SPEEDUP,
    LatencySummary,
    TaskBenchRunner,
    TaskReport,
    original_replay_stream,
    slice_stream,
    summarize_latencies,
)
