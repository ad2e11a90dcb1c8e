"""Controller — the user-side core component (paper §4).

The paper's controller has three functions, mirrored here:
  (1) control the producer to load + simulate a user-defined time range;
  (2) collect physical/workload metrics of the stream processing system;
  (3) manage metrics of different stream data for viewing.

The controller is a thin layer: :meth:`Controller.run` builds a one-cell
:class:`~repro_torch.streamsim.plan.SweepPlan` and hands it to the sweep
engine (:mod:`repro_torch.streamsim.engine`). What remains here is the
paper-side surface: the store, the metrics repository (a JSON directory),
and the per-dataset preprocessing timer.

``Controller(store_dir, device=None)``: the torch backend runs on
``device`` (``None`` means CUDA, and raises where CUDA is unavailable);
``device="cpu"`` runs the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import itertools
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.streamsim import engine
from repro_torch.streamsim.datasets import make_stream
from repro_torch.streamsim.engine import SimulationReport
from repro_torch.streamsim.nsa import nsa
from repro_torch.streamsim.plan import plan_sweep
from repro_torch.streamsim.preprocess import Stream, preprocess
from repro_torch.streamsim.queue import StreamQueue
from repro_torch.streamsim.store import StreamStore


class Controller:
    def __init__(self, store_dir: str, metrics_dir: Optional[str] = None,
                 device=None):
        self.store = StreamStore(store_dir)
        self.metrics_dir = Path(metrics_dir or (Path(store_dir) / "_metrics"))
        self.metrics_dir.mkdir(parents=True, exist_ok=True)
        self.device = device
        self._metrics_seq = itertools.count()
        #: the executed sweep of the latest :meth:`run` (its ``mode`` says
        #: whether the kernel chain ran or the host fallback did)
        self.last_result: Optional[engine.DeviceSweepResult] = None

    # ----------------------------------------------------- (1) simulate/run
    def prepare(self, dataset: str, *, scale: float = 1.0, seed: int = 0,
                force: bool = False) -> Stream:
        """POSD once, persist (preprocessing is a one-time job — paper §3.1)."""
        key = f"{dataset}__orig"
        if self.store.exists(key) and not force:
            return self.store.get(key)
        raw = make_stream(dataset, scale=scale, seed=seed)
        stream = preprocess(raw)
        self.store.put(key, stream, {"scale": scale, "seed": seed})
        return stream

    def simulate(self, dataset: str, max_range: int, *, scale: float = 1.0,
                 seed: int = 0, force: bool = False,
                 backend: str = "auto") -> Stream:
        """NSA once per (dataset, max_range), persist (paper §3.2). Every
        backend is bit-identical, so the store cache is backend-agnostic."""
        key = f"{dataset}__sim{max_range}"
        if self.store.exists(key) and not force:
            return self.store.get(key)
        original = self.prepare(dataset, scale=scale, seed=seed, force=force)
        sim = nsa(original, max_range, backend=backend, device=self.device)
        self.store.put(key, sim, {"max_range": max_range})
        return sim

    def _prepare_all(self, datasets: Sequence[str], scale: float,
                     seed: int) -> tuple:
        """POSD every dataset, timing each."""
        originals, t_pre = {}, {}
        for d in datasets:
            t0 = time.perf_counter()
            originals[d] = self.prepare(d, scale=scale, seed=seed)
            t_pre[d] = time.perf_counter() - t0
        return originals, t_pre

    def run(self, dataset: str, max_range: int,
            consumer: Callable[[StreamQueue], Dict], *,
            scale: float = 1.0, seed: int = 0,
            queue_size: int = 64, backend: str = "auto",
            autotune: Optional[str] = None) -> SimulationReport:
        """Full pipeline: POSD -> NSA -> PSDA -> consumer (the SPS task).

        Parameters
        ----------
        dataset : str
            Dataset name (see :func:`repro_torch.streamsim.datasets.
            make_stream`).
        max_range : int
            Simulated time range for NSA.
        consumer : callable
            Drains the queue on the calling thread and returns its own
            metrics dict.
        scale, seed :
            Synthetic-dataset shape parameters (store-cache keyed).
        queue_size : int, default 64
            Bounded-queue capacity; the producer honours backpressure.
        backend : {"auto", "numpy", "torch"}
            ``"torch"`` (and ``"auto"``) runs NSA and metrics through the
            kernels on the controller's device; ``"numpy"`` on the host.
            NSA output is bit-identical across backends; out-of-domain
            inputs fall back to numpy automatically.
        autotune : None or "off"
            Anything else raises ``NotImplementedError``.

        Returns
        -------
        SimulationReport
            Also persisted as JSON (function (3): the metrics repository).

        Raises
        ------
        RuntimeError
            If the producer reports a non-zero fault status, or the torch
            backend is asked for CUDA where CUDA is unavailable.
        """
        originals, t_pre = self._prepare_all([dataset], scale, seed)
        plan = plan_sweep(self.store, [dataset], [max_range],
                          {dataset: len(originals[dataset])},
                          scale=scale, seed=seed, n_hosts=1, host_index=0,
                          n_devices=1)
        result = engine.execute_sweep(plan, originals, self.store,
                                      backend=backend, device=self.device,
                                      autotune=autotune)
        self.last_result = result
        sim = result.materialize()[(dataset, max_range)]
        consumer_metrics, t_prod = engine.replay_one(sim, consumer,
                                                     queue_size)
        report = engine.build_report(result, (dataset, max_range),
                                     t_pre[dataset], t_prod,
                                     consumer_metrics)
        self.save_metrics(report)
        return report

    # -------------------------------------------------- (3) metrics manager
    def _unique_path(self, directory: Path, stem: str) -> Path:
        """ms stamp + a monotonic per-controller sequence number, so two
        reports landing in the same millisecond never overwrite each
        other."""
        path = directory / f"{stem}_{next(self._metrics_seq):06d}.json"
        while path.exists():
            path = directory / f"{stem}_{next(self._metrics_seq):06d}.json"
        return path

    def save_metrics(self, report: SimulationReport) -> Path:
        stem = (f"{report.dataset}_max{report.max_range}_"
                f"{int(time.time() * 1e3)}")
        path = self._unique_path(self.metrics_dir, stem)
        with open(path, "w") as f:
            json.dump(report.to_json(), f, indent=2, default=_np_default)
        return path

    def list_metrics(self) -> List[Path]:
        return sorted(self.metrics_dir.glob("*.json"))

    def load_metrics(self) -> List[Dict]:
        out = []
        for p in self.list_metrics():
            with open(p) as f:
                out.append(json.load(f))
        return out


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")
