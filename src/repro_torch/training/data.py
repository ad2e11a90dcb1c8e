"""Data plane: the bridge from simulated IoT streams to token batches
(a copy of the JAX package's ``training/data.py``, which imports no JAX).

This is where the paper's pipeline plugs into the SPS-as-training-job: the
PSDA producer emits per-second buckets into the StreamQueue; the
:class:`StreamBatcher` consumes buckets, tokenizes records, and yields fixed
(B, S) batches. Arrival volatility therefore directly shapes the batch
cadence — which is the load pattern the paper wants tests to see.

Tokenization of records is deliberately simple and vocabulary-stable:
column values hash into the LM vocab (a production system would plug a real
tokenizer here; the framework only needs id streams). String columns hash
with Python's ``hash()``, which is salted per process: two processes give
different ids for the same records, one process the same ids.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.streamsim.queue import Bucket, StreamQueue


def tokenize_bucket(bucket: Bucket, vocab: int,
                    tokens_per_record: int = 8) -> np.ndarray:
    """Hash each record's fields into `tokens_per_record` ids < vocab."""
    n = len(bucket)
    cols = [np.asarray(v) for v in bucket.payload.values()]
    acc = np.zeros((n, tokens_per_record), dtype=np.uint64)
    for ci, col in enumerate(cols):
        if col.dtype.kind in "US":
            h = np.array([hash(x) & 0xFFFFFFFF for x in col], np.uint64)
        else:
            h = col.astype(np.float64).view(np.uint64) if col.dtype.kind == "f" \
                else col.astype(np.uint64)
        for j in range(tokens_per_record):
            acc[:, j] ^= (h * np.uint64(0x9E3779B97F4A7C15 + 31 * (ci + 1)
                                        + 7 * j)) >> np.uint64(17)
    ts = (bucket.t * 1000).astype(np.uint64)
    acc ^= ts[:, None]
    return (acc % np.uint64(max(vocab - 2, 1)) + np.uint64(1)).astype(np.int32)


class StreamBatcher:
    """Pull buckets from the queue, emit {'inputs','labels'} LM batches."""

    def __init__(self, queue: StreamQueue, batch: int, seq: int, vocab: int,
                 tokens_per_record: int = 8):
        self.queue = queue
        self.batch = batch
        self.seq = seq
        self.vocab = vocab
        self.tpr = tokens_per_record
        self._buf = np.zeros((0,), np.int32)
        self.buckets_consumed = 0
        self.records_consumed = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        need = self.batch * (self.seq + 1)
        for bucket in self.queue:
            ids = tokenize_bucket(bucket, self.vocab, self.tpr).reshape(-1)
            self._buf = np.concatenate([self._buf, ids])
            self.buckets_consumed += 1
            self.records_consumed += len(bucket)
            while len(self._buf) >= need:
                chunk, self._buf = self._buf[:need], self._buf[need:]
                chunk = chunk.reshape(self.batch, self.seq + 1)
                yield {"inputs": chunk[:, :-1], "labels": chunk[:, 1:]}


class SyntheticBatcher:
    """Deterministic fallback batcher (tests / benchmarks without a stream)."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0):
        self.batch, self.seq, self.vocab = batch, seq, vocab
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            chunk = self.rng.integers(
                1, self.vocab, (self.batch, self.seq + 1), dtype=np.int32)
            yield {"inputs": chunk[:, :-1], "labels": chunk[:, 1:]}
