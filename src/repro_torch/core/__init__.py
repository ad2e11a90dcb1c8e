"""repro_torch.core — public API facade for the paper's contribution.

One-call entry point (:func:`simulate_stream`) plus re-exports of the
pipeline stages::

    from repro_torch.core import simulate_stream
    sim = simulate_stream("userbehavior", max_range=600)

maps to the paper's Fig. 4: POSD -> NSSD -> (PSD -> SPS via
``repro_torch.streamsim.Producer``).
"""

from __future__ import annotations

from repro_torch.streamsim import (  # noqa: F401
    Controller,
    Producer,
    RealClock,
    SimulationReport,
    Stream,
    StreamQueue,
    StreamStore,
    VirtualClock,
    make_stream,
    nsa,
    nsa_paper,
    per_second_counts,
    preprocess,
    volatility,
)


def simulate_stream(dataset: str, max_range: int, *, scale: float = 1.0,
                    seed: int = 0, backend: str = "numpy",
                    device=None) -> Stream:
    """POSD + NSA in one call (no persistence). ``backend="torch"`` runs
    NSA through the kernels on ``device`` (``None`` means CUDA). For the
    persistent, metrics-collecting path use
    :class:`repro_torch.streamsim.Controller`."""
    raw = make_stream(dataset, scale=scale, seed=seed)
    stream = preprocess(raw)
    return nsa(stream, max_range, backend=backend, device=device)


__all__ = [
    "Controller", "Producer", "RealClock", "SimulationReport", "Stream",
    "StreamQueue", "StreamStore", "VirtualClock", "make_stream", "nsa",
    "nsa_paper", "per_second_counts", "preprocess", "simulate_stream",
    "volatility",
]
