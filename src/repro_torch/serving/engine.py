"""Batched serving engine: continuous batching over prefill + decode.

Counterpart of ``repro/serving/engine.py``. The engine owns a fixed
number of decode slots. Each tick:

1. admit waiting requests into free slots (one batched prefill per tick
   builds their cache rows, merged into the slots),
2. run one decode step for all slots while any is active (an idle slot is
   decoded too, as in the reference; its position runs on past
   ``max_len`` and its cache writes are dropped),
3. retire sequences that hit EOS, their token budget or ``max_len - 1``,
   recording latencies.

Under the paper's scenario the request queue is fed by
:func:`repro_torch.serving.load.stream_arrivals`, so the engine sees the
compressed real-world arrival process, volatility and trend included.

The slots' KV cache is allocated once on ``device`` and updated in place
by every prefill merge and decode step (the reference donates it to its
jitted step). Greedy decoding takes ``argmax`` of the f32 logits, which,
like ``jnp.argmax``, picks the first of tied maxima.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import resolve_device
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32 token ids
    max_new_tokens: int = 16
    arrive_t: float = 0.0
    start_t: float = 0.0
    finish_t: float = 0.0
    generated: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeMetrics:
    admitted: int = 0
    finished: int = 0
    decode_steps: int = 0
    tokens_out: int = 0
    queue_peak: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)

    def summary(self) -> Dict:
        lat = sorted(self.latencies_s)
        return {
            "finished": self.finished,
            "tokens_out": self.tokens_out,
            "decode_steps": self.decode_steps,
            "p50_latency_s": lat[len(lat) // 2] if lat else 0.0,
            "p99_latency_s": lat[int(len(lat) * 0.99)] if lat else 0.0,
            "queue_peak": self.queue_peak,
        }


class ServingEngine:
    """Continuous-batching engine over ``slots`` decode slots of
    ``max_len`` cache positions each; ``params`` must lie on ``device``
    (default CUDA)."""

    def __init__(self, cfg: ModelConfig, params: Any, *, slots: int = 8,
                 max_len: int = 256, eos_id: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        self.cache = transformer.init_cache(cfg, slots, max_len, self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.waiting: List[Request] = []
        self.metrics = ServeMetrics()
        self._last_tokens = np.zeros((slots,), np.int32)

    def reset(self) -> None:
        """Empty the slots, the queue and the metrics; zero the cache in
        place."""
        for run in self.cache["runs"]:
            for t in run.values():
                t.zero_()
        self.cache["pos"].zero_()
        self.active = [None] * self.slots
        self.waiting = []
        self.metrics = ServeMetrics()
        self._last_tokens = np.zeros((self.slots,), np.int32)

    # ----------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.waiting.append(req)
        self.metrics.queue_peak = max(self.metrics.queue_peak,
                                      len(self.waiting))

    def _admit(self, now: float) -> None:
        free = [i for i, r in enumerate(self.active) if r is None]
        if not free or not self.waiting:
            return
        batch = []
        while free and self.waiting:
            batch.append((free.pop(0), self.waiting.pop(0)))
        maxp = max(max(len(r.prompt) for _, r in batch), 1)
        toks = np.zeros((len(batch), maxp), np.int32)
        lens = np.zeros((len(batch),), np.int32)
        for j, (_, r) in enumerate(batch):
            toks[j, :len(r.prompt)] = r.prompt
            lens[j] = len(r.prompt)
        logits, pcache = transformer.prefill(
            self.cfg, self.params, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(lens).to(self.device), max_len=self.max_len)
        first = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        _merge_cache(self.cache, pcache, [slot for slot, _ in batch])
        for j, (slot, r) in enumerate(batch):
            r.start_t = now
            r.generated = [int(first[j])]
            self.active[slot] = r
            self._last_tokens[slot] = first[j]
            self.metrics.admitted += 1
            self.metrics.ttft_s.append(now - r.arrive_t)
            self.metrics.tokens_out += 1

    # --------------------------------------------------------------- ticks
    def tick(self, now: Optional[float] = None) -> int:
        """Admit + one decode step. Returns number of active sequences."""
        now = time.perf_counter() if now is None else now
        self._admit(now)
        if not any(r is not None for r in self.active):
            return 0
        logits, self.cache = transformer.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(self._last_tokens).to(self.device))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.metrics.decode_steps += 1
        n_active = 0
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            tok = int(nxt[slot])
            r.generated.append(tok)
            self._last_tokens[slot] = tok
            self.metrics.tokens_out += 1
            done = (tok == self.eos_id
                    or len(r.generated) >= r.max_new_tokens
                    or len(r.prompt) + len(r.generated) >= self.max_len - 1)
            if done:
                r.finish_t = now
                self.metrics.latencies_s.append(now - r.arrive_t)
                self.metrics.finished += 1
                self.active[slot] = None
            else:
                n_active += 1
        return n_active

    def drain(self, max_ticks: int = 10_000, now: Optional[float] = None,
              tick_s: float = 0.0) -> None:
        """Run until idle. Pass ``now``/``tick_s`` to stay on a virtual
        clock (stream-driven load tests); default uses wall time."""
        t = 0
        while (self.waiting or any(r is not None for r in self.active)) \
                and t < max_ticks:
            self.tick(now if now is None else now + t * tick_s)
            t += 1


def _merge_cache(cache: Dict, pcache: Dict, slots: List[int]) -> None:
    """Copy prefilled cache rows (batch axis) into the engine cache's
    ``slots`` in place. Layer caches are (R, B, S, ...), zero-padded when
    the prefill cache is shorter; ``pos`` is (B,)."""
    idx = torch.tensor(slots, dtype=torch.long, device=cache["pos"].device)
    cache["pos"][idx] = pcache["pos"].to(cache["pos"].dtype)
    for run, prun in zip(cache["runs"], pcache["runs"]):
        for name, c in run.items():
            p = prun[name]
            if p.shape[2:] != c.shape[2:]:
                pad: List[int] = []
                for ax in reversed(range(2, p.ndim)):
                    pad += [0, c.shape[ax] - p.shape[ax]]
                p = F.pad(p, pad)
            c[:, idx] = p.to(c.dtype)
