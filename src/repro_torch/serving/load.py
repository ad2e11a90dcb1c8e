"""Stream-driven load generation: the paper's pipeline as a serving load test.

Counterpart of ``repro/serving/load.py``. Each per-second bucket emitted by
the PSDA producer becomes a burst of inference requests (one per stream
record, up to a cap, prompts tokenized from the record's fields). The
arrival process the engine sees therefore has the *original* stream's
per-second volatility and diurnal trend, compressed
``original_range / max_range``-fold in wall time.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.serving.engine import Request
from repro_torch.streamsim.queue import StreamQueue
from repro_torch.training.data import tokenize_bucket


def stream_arrivals(queue: StreamQueue, vocab: int, *,
                    prompt_len: int = 16, max_new_tokens: int = 8,
                    max_requests_per_bucket: int = 64
                    ) -> Iterator[Tuple[int, List[Request]]]:
    """Yield (scale_stamp, requests) per bucket from the producer queue."""
    rid = 0
    for bucket in queue:
        ids = tokenize_bucket(bucket, vocab, tokens_per_record=prompt_len)
        n = min(len(bucket), max_requests_per_bucket)
        reqs = []
        for i in range(n):
            reqs.append(Request(
                rid=rid,
                prompt=ids[i].astype(np.int32),
                max_new_tokens=max_new_tokens,
                arrive_t=float(bucket.emit_time),
            ))
            rid += 1
        yield bucket.scale_stamp, reqs
