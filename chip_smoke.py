#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing catches it):

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the CUDA kernels of B1-B8 from ``src/repro_torch/csrc`` and
   every tile instance of ``repro_torch.kernels.tuning`` (one ``nvcc`` per
   library, all started together), printing each build's seconds;
3. hold each kernel against its plain PyTorch version on the card:
   - B1-B3 at the run-path shapes of the userbehavior day (10.63 M
     records), at the sweep's 18-row shard (every dataset at every
     range), a ragged 4-row batch at max_range 60/600/1800/3600, a
     zero-span stream and a single-record stream — exact for integer
     outputs, 1e-5 relative for the moments (of the plain version's and
     in f64);
   - B3 on unsorted stamps: six rows of random latency-bin ids at 2048
     buckets, a day of random stamps at 86,528 buckets (the global-atomic
     branch), the original's sorted row beside a shuffled copy; two calls
     in a row bit-identical, the run shape after the largest unchanged;
   - B1 and B2 at their edges, bit-equal to their plain versions: rows of
     1003 records (not a multiple of the vector width), inputs in views
     that start off a 16-byte boundary, all-zero and all-ones masks, rows
     under one tile, random masks at 1 %, 50 % and 99 % over 18 rows, an
     18-row mask of more tiles than the card holds blocks at once, two
     calls in a row bit-identical and a smaller call after a larger one;
   - B4 (trend_scan) at the fidelity shape of max_range 3600 (the three
     originals' and sims' count rows), a ragged batch of lengths
     {0, 1, 1023, 1024, 1025, 86 400}, unpadded widths 0 and 1025, and one
     604 800-long row whose total sits just under 2^31 - 1 — exact, two
     calls in a row bit-identical, a smaller call after a larger one;
   - B5 (pair_stats) at the fidelity shape of max_range 3600, the task
     bench's S = 2 (K = 1024, 4096), S = 1, 37 (K = 86 528), 64, 65 and 130
     (K = 4096), K = 0, K = 1025 and a view off a 16-byte boundary —
     ``|G - G_plain| <= 1e-4 sqrt(G_aa G_bb)``, two calls in a row
     bit-identical, the fidelity shape after S = 130 unchanged;
   - B6 (stream_metrics_carry) at chunk 0 of the 1-day grid (18 rows: the
     kept stamps the chunked path hands it, and all 10,631,168 records of
     the slice), at a 1.77 M-record chunk of one row rebased by its first
     bucket, at ragged lengths with an all-padding row, on unsorted stamps
     around a chunk (some below its base, some past it) and at width 0,
     under zero and random carries — counts exact, the running sums within
     1e-5 relative, a zero carry equal to B3 bit for bit, two calls in a
     row bit-identical, the chunk shape after the largest unchanged;
   - B7 (trend_scan_carry) at the multi-day chunk shape (one 659-entry
     row), the fidelity shape, widths 0, 1 and 1025 and a 604 800-entry row
     whose seeded total ends just under 2^31 - 1 — exact, tail included,
     ``init = 0`` equal to B4 bit for bit, two calls in a row
     bit-identical, a smaller call after a larger one;
   - B8 (flash_decode) on the consumer LM's heads in f32 (G = 3, D = 64),
     llama3-8b's in bf16 (G = 4, D = 128), recurrentgemma-2b's local
     layers' (bf16, G = 10, D = 256, S 512 and 2048), command-r+'s (bf16,
     G = 12) and the smoke configs' (D = 16: f32 G = 2, bf16 G = 4),
     ragged lengths with 1, S a multiple of no block, lengths past S, and
     junk past each length (999s, NaN and +inf: bit-equal output) —
     within 2e-5 (f32) and 5e-2 (bf16) of the plain version, two calls in
     a row bit-identical, the serve shape after the decode_32k shape
     unchanged;
   - one device kernel per call of B1, B2 (its sentinel fill included),
     B3 and B6 (the histogram's zeroing and the moments included), B4, B5
     (its splits' fold included), B7 and B8 (``torch.profiler`` over five
     calls at the timing shapes, and B8 at recurrentgemma's, command-r+'s
     and a smoke shape; copies and fills not counted);
   timing kernel, plain version and the one-call library yardstick (CUDA
   events, median of several runs; B2 against ``torch.cumsum`` and, on
   one row, ``torch.nonzero``; B8 at B = 16, S = 32 768 with llama3-8b's
   heads and at recurrentgemma-2b's full rings, B = 8, S = 2048, against
   ``scaled_dot_product_attention``);
   - every non-default tile instance of B1-B7 (B1 1024 and 4096 records a
     block, B2 4096, 8192 and 16384 records a tile, B3/B6 2048-8192
     records times 256-1024 buckets a partial, B4/B7 1024 and 4096, B5's
     256 and 1024 quanta): its library reports the tiles asked for, it is
     held to its plain version (at its own bucket block) at the edge
     cases above -- B1 and B2 at their edges, B3 on unsorted rows, B6
     under zero and random carries, B4 and B7 near 2^31, B5 at S = 1 to
     130 and K = 0 and 1025 -- launches one device kernel per call, and
     every instance, the default's included, is timed at the run, sweep
     and (after phase 7) nine-day chunk shapes;
4. drive ``Controller(tmp, device="cuda").run("userbehavior", 3600, ...,
   scale=1.0, backend="torch")`` with every launch count set to 0 just
   before and read just after, and check it against the port's own
   ``backend="numpy"`` run on the same input;
5. drive ``Controller(fresh, device="cuda").run_many(("sogouq", "traffic",
   "userbehavior"), (600, 1200, 1800, 2400, 3000, 3600), ..., scale=1.0,
   backend="torch")`` (the paper's Tables 1-3 grid and its Fig.-6
   fidelity matrices) the same way, and check it against the port's
   ``backend="numpy"`` sweep: stored sims byte-equal, rows equal,
   statistics and fidelity matrices within 1e-3;
6. drive the same grid chunked, ``run_many(..., chunk_s=600)`` in a fresh
   store, and check it against phase 5's monolithic store and reports
   (stored sims byte-equal, rows and consumer stats equal, volatility
   within 1e-5, trend correlation and fidelity within 1e-3, at most two
   chunks buffered per scenario);
7. drive nine days of the userbehavior stream, ``run_many(("userbehavior",),
   (3600,), ..., chunk_s=600, duration_s=9 * 86400)`` (95.7 M records, 54
   chunk rounds), check it against the port's ``backend="numpy"`` chunked
   run on the same original, then drive B7 through
   ``ops.trend_scan_chunk`` over the finalized count row in 54 chunks and
   hold the concatenated trend to B4's bit for bit; B1 and B2 are then
   held to their plain versions and timed on B1's inputs for one of those
   chunks, rebuilt by ``ChunkedNSA.sample_inputs`` (the shape of 54 of
   their 63 launches), each beside its wrapper's host time;
8. drive ``python -m repro_torch.launch.serve`` at its defaults (the
   paper's consumer LM at full width, 12 layers in f32, sogouq compressed
   to 120 s at scale 0.01, 8 slots): every arrival finishes and B8 runs
   exactly once per decode step and layer;
9. drive ``Controller(tmp).run("sogouq", 120, consumer=ServingTask(...))``
   with llama3-8b at its published width (32 layers, d 4096, 32/8 heads,
   head_dim 128, bf16, seeded random weights on the card, 8 slots of 512
   positions): every request finishes, B8 runs once per decode step and
   layer, and B8 matches its plain version on the inputs of layers 0 and
   31 of a real decode step; prints the logits of that step through B8
   and through the plain version, prefill and decode step times, tokens/s
   and peak memory, then frees the weights;
10. drive the paper's task bench, ``TaskBenchRunner(("sogouq", "traffic",
   "userbehavior"), (600, 3600), scale=1.0, device="cuda",
   backend="torch").run(...)`` over the reference benchmark's ETL, 30 s
   window and threshold-4 detector tasks (18 reports, full days): launches
   exactly B5 = B4 = 18 and B3 = 3, records equal to the originals' and
   the sims', every speedup above 1, the detector's output series replayed
   again with the device chain within 1e-3 of ``backend="numpy"``, its
   latency summaries equal and its B3 histogram equal to ``np.bincount``,
   and the fidelity floor (0.75) on every report but a detector cell whose
   float64 numpy fidelity is itself below it (held to that value instead,
   and listed);
11. drive the public API on the userbehavior day at max_range 3600:
   ``ops.stream_sample``, ``compact_mask``, ``bucket_hist`` and
   ``volatility_stats`` held to ``stream_sample_ref``, ``compact_plain``,
   ``np.bincount`` and the float64 moments (1e-5 relative), then
   ``nsa_batched`` over the three datasets and ``nsa_sweep`` over the
   3 x 6 grid held bit for bit to ``nsa(..., backend="numpy")``; launches
   exactly B1 = B2 = 3 and B3 = 1 (``API_LAUNCHES``);
12. drive the sweep service: two participant processes on the one card
   (``chip_smoke.py --service-worker``, a two-rank ``gloo`` group that
   only supplies the topology) each run ``Controller(fresh,
   device="cuda").run_many(<the grid>, ..., backend="torch",
   service=True)``; both return the 18 reports, none poisoned, the
   scenarios they computed split the grid, rows and stored sims equal
   phase 5's and statistics within 1e-3, the merged matrices within 1e-9
   of phase 5's numpy matrices with provenance on every row; each
   participant launches B1 = B2 = its batches and B3 twice that, and
   loads the kernels phase 2 built without rebuilding them;
13. drive the static plan over two hosts, ``run_many(..., n_hosts=2,
   host_index=0 or 1)`` alternately in a fresh shared store until the
   grid is covered (five runs): launches exact per run (B1, B2 once for
   a computed slice, B3 for it and for the originals, B4 = B5 = the
   run's local matrices), the last run's merged matrices full, with
   provenance from host0 and host1, within 1e-9 of phase 5's numpy
   matrices;
14. drive phase 4's ``Controller.run`` in a fresh store with
   ``autotune="force"`` (no swept candidate may be dropped: every one
   builds, launches and matches its plain version), then, the simulated
   stream deleted, with ``autotune="cached"`` in the same store: no
   sweep, launches equal to phase 4's, the cache listing every key the
   run dispatched, both runs' simulated streams byte-equal to phase 4's
   numpy run;
15. drive ``python -m repro_torch.launch.train`` on the paper's consumer
   LM at full size (12 layers, d 768, vocab 32,768, f32) fed by the
   userbehavior stream at max_range 600, scale 0.02, batch 8 x 256, 60
   steps, a checkpoint every 20 and a crash injected at step 45: one
   restart, step 60 reached, a finite loss, the last 10 steps' mean loss
   below the first 10's, the stream consumed, no kernel launched; the
   first 3 steps replayed on the CPU from the same parameters and batches
   within 1e-4 relative, with TF32 off;
16. train llama3-8b at full width (d 4096, 32/8 heads, d_ff 14,336, vocab
   128,256, bf16), depth cut to 4 layers, on one 4096-token sequence:
   the step-0 loss and gradient norm with remat none and full within
   1e-2 (each one's peak device memory printed), the loss within 0.5 of
   ln V + 1/2; then 3 in-place train steps under a ``TrainLoop`` that
   checkpoints the bf16 state once, restored bit for bit; step time,
   tokens/s, peak memory and the checkpoint's seconds printed beside the
   card's name and power limit;
17. serve the other families at their published widths, each with seeded
   random bf16 weights on the card and its parameter leaves equal to the
   reference's (``FAMILY_LEAVES``): ``Controller.run("sogouq", 120,
   consumer=ServingTask(...))`` as in phase 9 on recurrentgemma-2b and
   rwkv6-1_6b whole, llama4-scout at 4 of its 48 layers and deepseek-v3
   at 5 of its 61 (the card's 80 GB): every request finishes, B8 runs
   exactly once per decode step and GQA layer (8, 0, 4, 0), B1-B3 at
   least as phase 9; then recurrentgemma's ring wrap (a 2560-token
   prompt with max_len 4096, 4 decode steps: B8 held to its plain
   version on a local layer's captured inputs, the logits reported
   against the teacher-forced forward), three full-depth train steps of
   recurrentgemma-2b and rwkv6-1_6b (B 1, S 512, remat full; the step-0
   loss under remat none and full within 1e-2, the parameters changed),
   and ``launch.serve --arch`` / ``launch.train --arch`` on the four
   families' and llama3-8b's smoke configs;
18. print the ``b1_b2_edges``, ``report``, ``sweep``, ``chunked``,
   ``multiday``, ``serve``, ``serve_llama3``, ``taskbench``, ``api``,
   ``service``, ``multihost``, ``tuning``, ``train``, ``train_llama3``,
   ``families`` and ``kernels`` JSON lines and, last, the ``{"ok": true,
   "device": ...}`` line.

Every phase sets each launch count to 0 just before it drives its path and
reads the counts just after.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
#: float32 rate outside the tensor cores, against which the kernels'
#: scalar f32 and int32 operations are both counted
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

MAIN_DATASET, MAIN_RANGE, MAIN_SCALE, MAIN_SEED = "userbehavior", 3600, 1.0, 0
SWEEP_DATASETS = ("sogouq", "traffic", "userbehavior")
SWEEP_RANGES = (600, 1200, 1800, 2400, 3000, 3600)
MOMENT_RTOL = 1e-5
#: B5's bound: |G - G_plain| <= GRAM_RTOL * sqrt(G_plain[a,a] G_plain[b,b])
#: (and, by Cauchy-Schwarz, |sums - plain| <= GRAM_RTOL sqrt(K G[a,a]))
GRAM_RTOL = 1e-4
STAT_TOL = 1e-3
#: launches each kernel must show on the run path: B1 and B2 once, B3 for
#: the kept stamps and again for the original stream's report statistics
MIN_LAUNCHES = {"stream_sample": 1, "compact": 1, "metrics_fused": 2}
#: ... and on the sweep path: one B1/B2 shard, B3 for the shard and the
#: originals, B4 and B5 once per max_range's fidelity matrix
MIN_SWEEP_LAUNCHES = {"stream_sample": 1, "compact": 1, "metrics_fused": 2,
                      "trend_scan": len(SWEEP_RANGES),
                      "pair_stats": len(SWEEP_RANGES)}
CHUNK_S = 600
#: ... on the chunked grid: B1, B2 and B6 once per chunk round of the one
#: 18-row shard (3600 / 600), B3 for the originals, B4 and B5 per range
CHUNKED_LAUNCHES = {"stream_sample": 6, "compact": 6,
                    "stream_metrics_carry": 6, "metrics_fused": 1,
                    "trend_scan": len(SWEEP_RANGES),
                    "pair_stats": len(SWEEP_RANGES)}
#: nine days of the Taobao UserBehavior stream (the public dataset spans
#: 2017-11-25 to 2017-12-03), compressed to an hour per day
MULTIDAY_S = 9 * 86_400
MULTIDAY_CHUNKS = 9 * MAIN_RANGE // CHUNK_S
MULTIDAY_LAUNCHES = {"stream_sample": MULTIDAY_CHUNKS,
                     "compact": MULTIDAY_CHUNKS,
                     "stream_metrics_carry": MULTIDAY_CHUNKS,
                     "metrics_fused": 1, "trend_scan": 1, "pair_stats": 1,
                     "trend_scan_carry": MULTIDAY_CHUNKS}
TREND_WINDOW = 60
#: the nine-day chunk whose B1 inputs are rebuilt for the chunk-shape timings
#: of B1 and B2: [1800, 2400) s of the first day
MULTIDAY_TIMED_CHUNK = 3


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, flush_bytes: int = 256 << 20) -> float:
    """Median device time of ``fn()`` over ``reps`` runs after one warm-up,
    each run between its own pair of CUDA events and started with a cold
    L2: a buffer larger than the 50 MB L2 (256 MiB unless ``flush_bytes``
    says otherwise) is read before each run, outside the timed span (read,
    not written, so no dirty lines are left to be written back inside the
    span). The read keeps the card busy while the host queues ``fn``'s
    launch, so the wrapper's host time stays out of the span unless it is
    longer than the read (:func:`_enqueue_ms` reports it). On an H100 a
    64 MiB read gave the same times as 256 MiB in a quiet process, but
    let host time into the span at the nine-day chunk shape after the
    multi-day run, where the wrappers' host time is longest."""
    import torch
    fn()
    flush = torch.ones(flush_bytes // 4, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.sum()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _enqueue_ms(fn, reps: int) -> float:
    """Median host time of one call of ``fn()`` after one warm-up: the
    wrapper's own work up to its launch returning, each call made while
    the card is still reading a 256 MiB buffer, so it never waits for the
    device. Not part of :func:`_time_ms`'s span."""
    import torch
    fn()
    flush = torch.ones(64 << 20, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.sum()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def _bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _exact(name: str, got, want) -> None:
    if got.shape != want.shape or got.dtype != want.dtype or \
            not bool((got == want).all()):
        raise AssertionError(f"{name}: kernel and plain version differ")


def _moments_err(name: str, got, want) -> float:
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    if not np.allclose(g, w, rtol=MOMENT_RTOL, atol=0.0):
        raise AssertionError(f"{name}: moments {g} vs {w} beyond "
                             f"{MOMENT_RTOL} relative")
    return float(np.abs(g - w).max(initial=0.0))


def _wrappers():
    """The eight kernel wrappers, each with its ``launches`` count."""
    from repro_torch.kernels.compact import compact
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.metrics_fused import (stream_metrics,
                                                   stream_metrics_carry)
    from repro_torch.kernels.stream_sample import stream_sample
    from repro_torch.kernels.trend_scan import (pair_stats, trend_scan,
                                                trend_scan_carry)
    return {"stream_sample": stream_sample, "compact": compact,
            "metrics_fused": stream_metrics, "trend_scan": trend_scan,
            "pair_stats": pair_stats,
            "stream_metrics_carry": stream_metrics_carry,
            "trend_scan_carry": trend_scan_carry,
            "flash_decode": flash_decode}


def _zero_launches():
    for w in _wrappers().values():
        w.launches = 0


def _read_launches():
    return {name: w.launches for name, w in _wrappers().items()}


def _check_launches(path: str, launches, expected, exact: bool) -> None:
    for name, want in expected.items():
        got = launches[name]
        if (got != want) if exact else (got < want):
            raise AssertionError(f"{name} launched {got} times on {path}, "
                                 f"expected {'' if exact else '>= '}{want}")


def _same_twice(name: str, fn) -> None:
    """Two back-to-back calls of ``fn`` give bit-identical outputs (the
    kernels keep tickets and status words in a per-stream workspace)."""
    import torch
    a, b = fn(), fn()
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{name}: two calls in a row differ")


def _kernels_per_call(name: str, fn, calls: int = 5) -> float:
    """Device kernels per call of ``fn`` under ``torch.profiler`` (copies
    and fills not counted), after one call outside the window that sizes
    any workspace; fails unless it is exactly one. A kernel counts once
    whether the profiler saw its launch on the host (``cudaLaunchKernel``
    and kin) or its run on the device: the larger of the two counts is
    taken, since the device's asynchronous record of a kernel can be
    missing from a window where its launch is not."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels, launches = [], 0
    for e in prof.events():
        if getattr(e, "device_type", None) is not None and \
                e.device_type.name == "CUDA":
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels.append(e.name)
        elif e.name.startswith(("cudaLaunch", "cuLaunch")):
            launches += 1
    per_call = max(len(kernels), launches) / calls
    if per_call != 1.0:
        raise AssertionError(f"{name}: {len(kernels)} device kernels and "
                             f"{launches} kernel launches in {calls} calls "
                             f"({sorted(set(kernels))}), expected one per "
                             "call")
    return per_call


# ----------------------------------------------------------- phase 3: kernels
@functools.lru_cache(maxsize=None)
def _streams(scale: float, seed: int):
    """The real streams the checks run on: the three paper datasets at
    ``scale`` plus the degenerate shapes NSA must survive."""
    from repro_torch.streamsim import make_stream, preprocess
    out = {d: preprocess(make_stream(d, scale=scale, seed=seed))
           for d in ("userbehavior", "sogouq", "traffic")}
    t0 = float(out["userbehavior"].t[0])
    return out, np.full(5000, t0), np.array([t0])


def check_kernels(device: str, scale: float, seed: int,
                  timing_reps: int = 20, plain_reps: int = 3,
                  keep_cases=None):
    """Phase 3: every kernel against its plain version at every case;
    returns the per-kernel timing rows of the main-path shapes. With
    ``keep_cases`` (a dict), B1's and B2's outputs of the ``main``,
    ``ragged`` and ``sweep`` cases are left there for
    :func:`check_carry_kernels`."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.metrics_fused import (stream_metrics,
                                                   stream_metrics_plain)
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    from repro_torch.streamsim.metrics import _bucket_series
    from repro_torch.streamsim.nsa import _multiple

    streams, flat, single = _streams(scale, seed)
    main = streams[MAIN_DATASET]

    def up(arrays):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in arrays]

    def mult(t, mr):
        return _multiple(len(t), float(t[-1] - t[0]), mr, "time")

    ub = streams["userbehavior"].t
    cases = {
        "main": ([main.t], [MAIN_RANGE]),
        "ragged": ([ub, streams["sogouq"].t, streams["traffic"].t,
                    ub[:1000]], [60, 600, 1800, 3600]),
        "zero_span": ([flat], [600]),
        "single": ([single], [600]),
        # the run_many shard: every (dataset, range) of the paper grid
        "sweep": ([streams[d].t for d in SWEEP_DATASETS
                   for _ in SWEEP_RANGES],
                  [mr for _ in SWEEP_DATASETS for mr in SWEEP_RANGES]),
    }
    errs = {"stream_sample": 0.0, "compact": 0.0, "metrics_fused": 0.0}
    timed = {}
    for case, (ts, ranges) in cases.items():
        mults = [mult(t, mr) for t, mr in zip(ts, ranges)]
        b1_in = up(ops.stream_sample_inputs(ts, ranges, mults))
        ss, keep = stream_sample(*b1_in)
        ss_p, keep_p = stream_sample_plain(*b1_in)
        _exact(f"stream_sample/{case}/ss", ss, ss_p)
        _exact(f"stream_sample/{case}/keep", keep, keep_p)
        idx, tot = compact(keep)
        idx_p, tot_p = compact_plain(keep)
        _exact(f"compact/{case}/idx", idx, idx_p)
        _exact(f"compact/{case}/totals", tot, tot_p)
        buckets = -(-max(ranges) // ops.BUCKET_BLOCK) * ops.BUCKET_BLOCK
        kept = _kept_stamps(ss, idx, tot)
        errs["metrics_fused"] = max(errs["metrics_fused"],
                                    _b3_err(case, kept, tot, buckets))
        if case in ("main", "sweep"):
            timed[case] = _b123_timings(b1_in, ss, keep, tot, kept,
                                        buckets, timing_reps, plain_reps)
        if case == "main":
            main_b1, main_keep = b1_in, keep
            main_b3 = (kept, tot, buckets)
        if keep_cases is not None and case in ("main", "ragged", "sweep"):
            keep_cases[case] = dict(ss=ss, lengths=b1_in[-1], kept=kept,
                                    totals=tot, b1_in=b1_in, keep=keep)

    # B3's second main-path launch: the ORIGINAL stream at 86 400 buckets
    b_orig, tr = _bucket_series(main, None, None)
    ssb, lens, buckets = ops.stream_metrics_inputs([b_orig], tr)
    ss_o, len_o = up([ssb, lens])
    hist, mom = stream_metrics(ss_o, len_o, buckets)
    hist_p, mom_p = stream_metrics_plain(ss_o, len_o, buckets)
    _exact("metrics_fused/original/hist", hist, hist_p)
    errs["metrics_fused"] = max(errs["metrics_fused"], _moments_err(
        "metrics_fused/original", mom, mom_p))
    want = np.bincount(b_orig, minlength=buckets).astype(np.float64)
    _moments_err("metrics_fused/original/f64", mom, torch.tensor(
        [[want.sum(), (want * want).sum()]]))
    errs["metrics_fused"] = max(errs["metrics_fused"], _check_unsorted_b3(
        device, seed, b_orig, ssb.shape[1], smaller=main_b3))
    S, N = ss_o.shape
    row = ss_o[0, :int(len_o[0])]
    rows = {name: dict(timed["main"][name], sweep=timed["sweep"][name])
            for name in ("stream_sample", "compact")}
    rows["stream_sample"]["kernels_per_call"] = _kernels_per_call(
        "stream_sample", lambda: stream_sample(*main_b1))
    rows["compact"]["kernels_per_call"] = _kernels_per_call(
        "compact", lambda: compact(main_keep))
    rows["metrics_fused"] = dict(
        ms=_time_ms(lambda: stream_metrics(ss_o, len_o, buckets),
                    timing_reps),
        plain_ms=_time_ms(lambda: stream_metrics_plain(ss_o, len_o, buckets),
                          plain_reps),
        library_ms=_time_ms(lambda: torch.bincount(row, minlength=buckets),
                            timing_reps),
        host_ms=_enqueue_ms(lambda: stream_metrics(ss_o, len_o, buckets),
                            timing_reps),
        shape=f"S={S} N={N} B={buckets} (original stream)",
        sim=timed["main"]["metrics_fused"],
        sweep=timed["sweep"]["metrics_fused"],
        kernels_per_call=_kernels_per_call(
            "metrics_fused", lambda: stream_metrics(ss_o, len_o, buckets)))
    rows["metrics_fused"]["bound_ms"], rows["metrics_fused"]["bound_by"] = \
        _bound_ms(S * N * 4 + S * 4 + S * buckets * 4 + S * 8,
                  S * N * 3 + S * buckets * 4)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def _b3_err(name: str, ss, lengths, buckets: int, config=None) -> float:
    """B3 (the instance ``config`` names) against its plain version at the
    same bucket block (counts exact, moments within MOMENT_RTOL) and
    against the moments of its counts in f64; returns the largest moment
    difference from the plain version."""
    import torch

    from repro_torch.kernels.metrics_fused import (bucket_block_of,
                                                   stream_metrics,
                                                   stream_metrics_plain)
    hist, mom = stream_metrics(ss, lengths, buckets, config=config)
    hist_p, mom_p = stream_metrics_plain(
        ss, lengths, buckets, bucket_block=bucket_block_of(config))
    _exact(f"metrics_fused/{name}/hist", hist, hist_p)
    q = hist.double()
    _moments_err(f"metrics_fused/{name}/f64", mom, torch.stack(
        [q.sum(1), (q * q).sum(1)], dim=1))
    return _moments_err(f"metrics_fused/{name}", mom, mom_p)


def _check_unsorted_b3(device: str, seed: int, original, width: int,
                       smaller=None, config=None):
    """B3 on unsorted stamps: six rows of uniform random latency-bin ids
    in [0, 2048) at 2048 buckets (the task tier's input), one row of
    ``width`` uniform random stamps over a day's 86,400 seconds at 86,528
    buckets (every tile spans more than the shared-memory range: the
    global-atomic branch), and a batch of the ``original`` bucket series
    (sorted; its length not a multiple of 4, so the kernel's scalar loads)
    beside a shuffled copy cut 12,345 records short. Also two calls in a
    row bit-identical, and ``smaller`` = (stamps, lengths, buckets) after
    the largest call unchanged. With ``config``, the instance it names, at
    widths padded to its bucket block. Returns the largest moment
    difference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.metrics_fused import (bucket_block_of,
                                                   stream_metrics)
    rng = np.random.default_rng(seed)
    block = bucket_block_of(config)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    n = len(original)
    day = ops._padded_buckets(86_528, block)
    cases = {
        "latency_bins": (up(rng.integers(0, 2048, (6, 443_392))),
                         up([443_392] * 5 + [300_001]), 2048),
        "day_unsorted": (up(rng.integers(0, 86_400, (1, width))),
                         up([width]), day),
        "sorted_beside_shuffled": (
            up(np.stack([original, rng.permutation(original)])),
            up([n, n - 12_345]), day),
    }
    err = 0.0
    for case, (ss, lengths, buckets) in cases.items():
        err = max(err, _b3_err(case, ss, lengths, buckets, config))
        _same_twice(f"metrics_fused/{case}",
                    lambda: stream_metrics(ss, lengths, buckets,
                                           config=config))
    if smaller is not None:
        _b3_err("main after sorted_beside_shuffled", *smaller, config)
    return err


def _b1_bound(b1_in, ss):
    """B1's bound: per record a 4-byte read of t, a 4-byte stamp and a
    keep byte written, ~30 operations; per row the scalars and length,
    and of its three 4-byte tables only the buckets its records read,
    from one below its least stamp to one above its greatest (the f32
    guess lands within one bucket of the stamp), at most the table's
    width: a nine-day chunk spans ~600 of its 32,400 buckets."""
    S, N = b1_in[0].shape
    span = (ss.amax(dim=1) - ss.amin(dim=1)).long() + 3
    tables = int(3 * 4 * span.clamp(max=b1_in[1].shape[1]).sum())
    return _bound_ms(S * N * (4 + 4 + 1) + tables + S * 16, S * N * 30)


def _b2_bound(keep):
    """B2's bound: each mask byte read once, each 4-byte index slot and
    total written once, one scan step a record."""
    R, N = keep.shape
    return _bound_ms(R * N * (1 + 4) + R * 4, R * N * 4)


def _b12_timings(b1_in, ss, keep, tot, timing_reps: int, plain_reps: int):
    """Kernel, plain and library times of B1 and B2 at one case's shapes,
    each with its bound. B2's library call is ``torch.cumsum`` (the scan
    alone); on a one-row mask ``torch.nonzero`` is timed as well
    (``library_nonzero_ms``). Neither is called by the port."""
    import torch

    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    S, N = b1_in[0].shape
    W = b1_in[1].shape[1]
    out = {"stream_sample": dict(
        ms=_time_ms(lambda: stream_sample(*b1_in), timing_reps),
        plain_ms=_time_ms(lambda: stream_sample_plain(*b1_in), plain_reps),
        host_ms=_enqueue_ms(lambda: stream_sample(*b1_in), timing_reps),
        library_ms=None, shape=f"S={S} N={N} W={W}")}
    out["stream_sample"]["bound_ms"], out["stream_sample"]["bound_by"] = \
        _b1_bound(b1_in, ss)
    out["compact"] = dict(
        ms=_time_ms(lambda: compact(keep), timing_reps),
        plain_ms=_time_ms(lambda: compact_plain(keep), plain_reps),
        host_ms=_enqueue_ms(lambda: compact(keep), timing_reps),
        library_ms=_time_ms(
            lambda: torch.cumsum(keep, dim=1, dtype=torch.int32),
            timing_reps),
        shape=f"R={S} N={N} kept={int(tot.sum())}")
    out["compact"]["bound_ms"], out["compact"]["bound_by"] = \
        _b2_bound(keep)
    if S == 1:
        out["compact"]["library_nonzero_ms"] = _time_ms(
            lambda: torch.nonzero(keep[0]), timing_reps)
    return out


def _b123_timings(b1_in, ss, keep, tot, kept, buckets: int,
                  timing_reps: int, plain_reps: int):
    """Kernel, plain and library times of B1, B2 and B3 (on the kept
    stamps) at one case's shapes, each with its bound."""
    import torch

    from repro_torch.kernels.metrics_fused import (stream_metrics,
                                                   stream_metrics_plain)
    out = _b12_timings(b1_in, ss, keep, tot, timing_reps, plain_reps)
    Sk, Nk = kept.shape
    row = kept[0, :int(tot[0])]
    out["metrics_fused"] = dict(
        ms=_time_ms(lambda: stream_metrics(kept, tot, buckets), timing_reps),
        plain_ms=_time_ms(lambda: stream_metrics_plain(kept, tot, buckets),
                          plain_reps),
        host_ms=_enqueue_ms(lambda: stream_metrics(kept, tot, buckets),
                            timing_reps),
        library_ms=_time_ms(lambda: torch.bincount(row, minlength=buckets),
                            timing_reps),
        shape=f"S={Sk} N={Nk} B={buckets} kept={int(tot.sum())}")
    out["metrics_fused"]["bound_ms"], out["metrics_fused"]["bound_by"] = \
        _bound_ms(Sk * Nk * 4 + Sk * 4 + Sk * buckets * 4 + Sk * 8,
                  Sk * Nk * 3 + Sk * buckets * 4)
    return out


def check_sample_compact_edges(device: str, scale: float, seed: int,
                               b1_config=None, b2_config=None):
    """Phase 3 for B1's and B2's edges, each bit-equal to its plain
    version: rows whose length is not a multiple of the vector width,
    views that start off a 16-byte boundary, all-zero and all-ones masks,
    rows under one tile, random masks at 1 %, 50 % and 99 % over 18 rows of
    many tiles, a mask of more tiles than the card holds blocks at once (a
    deadlock would hang here), two calls in a row bit-identical and a
    smaller call after a larger one; B1 and B2 the instances the configs
    name (``None``: the default libraries). Returns what it checked."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    from repro_torch.streamsim.nsa import _multiple

    streams, _, _ = _streams(scale, seed)
    rng = np.random.default_rng(seed)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def b1_inputs(ts, ranges):
        mults = [_multiple(len(t), float(t[-1] - t[0]), mr, "time")
                 for t, mr in zip(ts, ranges)]
        return [up(x) for x in ops.stream_sample_inputs(ts, ranges, mults)]

    def off_boundary(x, shift):
        """``x`` copied into a buffer ``shift`` elements in: the same
        values in a contiguous view whose data starts off a 16-byte
        boundary."""
        buf = torch.empty(x.numel() + shift, dtype=x.dtype, device=device)
        view = buf[shift:].view(x.shape)
        view.copy_(x)
        if view.data_ptr() % 16 == 0 or not view.is_contiguous():
            raise AssertionError("off_boundary: view is aligned")
        return view

    def same_b1(case, args):
        ss, keep = stream_sample(*args, config=b1_config)
        ss_p, keep_p = stream_sample_plain(*args)
        _exact(f"stream_sample/{case}/ss", ss, ss_p)
        _exact(f"stream_sample/{case}/keep", keep, keep_p)
        _same_twice(f"stream_sample/{case}",
                    lambda: stream_sample(*args, config=b1_config))

    def same_b2(case, mask):
        idx, tot = compact(mask, config=b2_config)
        idx_p, tot_p = compact_plain(mask)
        _exact(f"compact/{case}/idx", idx, idx_p)
        _exact(f"compact/{case}/totals", tot, tot_p)
        _same_twice(f"compact/{case}",
                    lambda: compact(mask, config=b2_config))

    # B1: three real streams cut to 1003 records (N not a multiple of 8),
    # and the run-shape inputs with t off a 16-byte boundary
    ts = [streams[d].t[:1003] for d in SWEEP_DATASETS]
    short = b1_inputs(ts, [600, 1800, 3600])
    short[0] = short[0][:, :1003].contiguous()
    same_b1("n1003", short)
    main = b1_inputs([streams[MAIN_DATASET].t], [MAIN_RANGE])
    same_b1("t_off_boundary", [off_boundary(main[0], 3), *main[1:]])
    same_b1("main_after_n1003", main)

    # B2
    def bits(shape, p):
        return up(rng.random(shape) < p)

    tile = 16_384                      # B2's larger tile
    card = torch.cuda.get_device_properties(torch.device(device)) \
        if torch.device(device).type == "cuda" else None
    # blocks the card holds at once: at most 2048 threads per SM over
    # 256-thread blocks
    resident = 8 * card.multi_processor_count if card is not None else 0
    wave = (18, 1 << 21)
    if wave[0] * -(-wave[1] // tile) <= resident:
        raise AssertionError("compact/multi_wave: grid fits in one wave")
    masks = {
        "n4099": bits((3, 4099), 0.5),
        "under_tile": bits((5, 1000), 0.3),
        "all_zero": torch.zeros((4, 70_001), dtype=torch.bool,
                                device=device),
        "all_ones": torch.ones((4, 70_001), dtype=torch.bool,
                               device=device),
        "p01": bits((18, 300_000), 0.01),
        "p50": bits((18, 300_000), 0.5),
        "p99": bits((18, 300_000), 0.99),
        "multi_wave": bits(wave, 0.04),
        "width0": torch.zeros((3, 0), dtype=torch.bool, device=device),
    }
    masks["off_boundary"] = off_boundary(bits((1, 100_000), 0.3), 3)
    for case, mask in masks.items():
        same_b2(case, mask)
    # a smaller call after the largest reuses its workspace
    same_b2("under_tile_after_multi_wave", masks["under_tile"])
    return {"stream_sample": ["n1003", "t_off_boundary", "main_after_n1003"],
            "compact": [*masks, "under_tile_after_multi_wave"],
            "compact_resident_blocks": resident,
            "compact_multi_wave_tiles": wave[0] * -(-wave[1] // tile)}


# ------------------------------------------------------- B4 and B5 (phase 3)
def _fidelity_counts(streams, max_range: int):
    """The count rows of one fidelity matrix of the sweep at ``max_range``:
    the originals' per-second counts, then the sims', as the engine stacks
    them. Returns ``(q int32 (6, W), lengths)``."""
    from repro_torch.streamsim import nsa, per_second_counts
    rows = [per_second_counts(streams[d]) for d in SWEEP_DATASETS] + \
        [per_second_counts(nsa(streams[d], max_range, backend="numpy"))
         for d in SWEEP_DATASETS]
    lengths = np.array([len(r) for r in rows], np.int64)
    q = np.zeros((len(rows), int(lengths.max())), np.int32)
    for i, r in enumerate(rows):
        q[i, :len(r)] = r
    return q, lengths


def _centered_trends(q, lengths, window: int):
    """B5's input on the engine's chain, through the plain scan: trends ->
    resample onto the shortest row -> centering -> PAIR_TILE padding."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.trend_scan import trend_scan_plain
    dev = q.device
    w_eff, half = ops._window_tables(lengths, window)
    trend = ops._trend_from_prefix(trend_scan_plain(q), *(
        torch.from_numpy(a).to(dev) for a in (lengths, w_eff, half)))
    z = ops._resample_uniform(trend, torch.from_numpy(lengths).to(dev),
                              int(lengths.min()))
    return ops._pad_cols(z - z.mean(dim=1, keepdim=True), ops.PAIR_TILE)


def _pair_err(name: str, got, want, k: int) -> float:
    """B5 against its plain version: the Gram within GRAM_RTOL of
    sqrt(G_aa G_bb), the row sums within GRAM_RTOL sqrt(k G_aa); returns
    the largest Gram difference, absolute and over sqrt(G_aa G_bb)."""
    (s, g), (s_p, g_p) = [[t.double().cpu().numpy() for t in pair]
                          for pair in (got, want)]
    d = np.clip(np.diag(g_p), 0.0, None)
    scale = np.sqrt(np.outer(d, d))
    diff = np.abs(g - g_p)
    if g.shape != g_p.shape or s.shape != s_p.shape or \
            not (diff <= GRAM_RTOL * scale).all():
        raise AssertionError(f"{name}: Gram beyond {GRAM_RTOL} of "
                             "sqrt(G_aa G_bb)")
    if not (np.abs(s - s_p)[:, 0] <= GRAM_RTOL * np.sqrt(k * d)).all():
        raise AssertionError(f"{name}: row sums beyond {GRAM_RTOL} of "
                             "sqrt(K G_aa)")
    with np.errstate(invalid="ignore", divide="ignore"):
        scaled = np.where(scale > 0, diff / np.where(scale > 0, scale, 1.0),
                          0.0)
    return float(diff.max(initial=0.0)), float(scaled.max(initial=0.0))


@functools.lru_cache(maxsize=None)
def _scan_cases(device: str, scale: float, seed: int):
    """B4's cases (built once per device, scale and seed): the fidelity
    shape of the sweep's largest range, a ragged batch, widths 0 and 1025,
    and the week row whose total sits just under 2^31 - 1; and the
    fidelity rows' lengths."""
    import torch

    from repro_torch.kernels import ops
    streams, _, _ = _streams(scale, seed)
    rng = np.random.default_rng(seed)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    q_np, lengths = _fidelity_counts(streams, max(SWEEP_RANGES))
    lens_ragged = [0, 1, 1023, 1024, 1025, 86_400]
    ragged = np.zeros((len(lens_ragged), 86_400), np.int32)
    for i, n in enumerate(lens_ragged):
        ragged[i, :n] = rng.poisson(120.0, n)
    week = np.full((1, 604_800), 3550, np.int32)    # total 2 147 040 000
    return {
        "fidelity": ops._pad_cols(up(q_np), ops.TILE),
        "ragged": ops._pad_cols(up(ragged), ops.TILE),
        "width0": up(np.zeros((3, 0), np.int32)),
        "width1025": up(rng.poisson(9.0, (2, 1025)).astype(np.int32)),
        "week": ops._pad_cols(up(week), ops.TILE),
    }, lengths


def _check_scan(scan_cases, config=None) -> None:
    """B4 (the instance ``config`` names) bit-equal to its plain version at
    every case, twice in a row, and after the largest call."""
    from repro_torch.kernels.trend_scan import trend_scan, trend_scan_plain

    def scan(q):
        return trend_scan(q, config=config)

    for case, q in scan_cases.items():
        _exact(f"trend_scan/{case}", scan(q), trend_scan_plain(q))
        _same_twice(f"trend_scan/{case}", lambda: scan(q))
    if int(scan(scan_cases["week"])[0, -1]) != 604_800 * 3550:
        raise AssertionError("trend_scan/week: wrong total")
    # a smaller call after a larger one reuses the larger workspace
    q_fid = scan_cases["fidelity"]
    _exact("trend_scan/fidelity after week", scan(q_fid),
           trend_scan_plain(q_fid))


def _pair_cases(device: str, seed: int, z_fid):
    """B5's cases: the fidelity shape, S = 1, 2, 37, 64, 65 and 130, K = 0
    and 1025, and a view off a 16-byte boundary."""
    import torch
    rng = np.random.default_rng(seed)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def centered(S, K):
        x = rng.normal(0.0, 40.0, (S, K)).astype(np.float32)
        return up(x - x.mean(axis=1, keepdims=True) if K else x)

    base = up(rng.normal(0.0, 3.0, 37 * 4096 + 1).astype(np.float32))
    cases = {
        "fidelity": z_fid, "S37": centered(37, 86_528),
        # the task bench's S = 2 shapes (max_range 600 and 3600 against
        # a day's original, padded to PAIR_TILE)
        "S2_K1024": centered(2, 1024), "S2_K4096": centered(2, 4096),
        "S1": centered(1, 4096), "S64": centered(64, 4096),
        "S65": centered(65, 4096), "S130": centered(130, 4096),
        "K0": centered(5, 0), "K1025": centered(37, 1025),
        "off16": base[1:1 + 37 * 4096].view(37, 4096),
    }
    if cases["off16"].data_ptr() % 16 == 0:
        raise AssertionError("pair_stats/off16: the view is aligned")
    return cases


def _check_pairs(pair_cases, config=None):
    """B5 (planned with ``config``'s quantum) within GRAM_RTOL of its plain
    version at every case, twice in a row bit-identical, and the fidelity
    shape after the largest tile grid unchanged; returns the largest
    absolute and scaled Gram differences."""
    import torch

    from repro_torch.kernels.trend_scan import pair_stats, pair_stats_plain

    def pairs(x):
        return pair_stats(x, config=config)

    err = scaled_err = 0.0
    for case, x in pair_cases.items():
        e, se = _pair_err(f"pair_stats/{case}", pairs(x),
                          pair_stats_plain(x), x.shape[1])
        err, scaled_err = max(err, e), max(scaled_err, se)
        _same_twice(f"pair_stats/{case}", lambda: pairs(x))
    # a smaller call after the largest tile grid reuses its workspace
    z_fid = pair_cases["fidelity"]
    fid = pairs(z_fid)
    pairs(pair_cases["S130"])
    if not all(torch.equal(a, b) for a, b in zip(fid, pairs(z_fid))):
        raise AssertionError("pair_stats/fidelity after S130 changed")
    return err, scaled_err


def check_trend_kernels(device: str, scale: float, seed: int,
                        timing_reps: int = 20, plain_reps: int = 3):
    """Phase 3 for B4 and B5: each against its plain version at every
    case; returns their timing rows at the fidelity shapes of the sweep's
    largest range (the shapes the main path gives them)."""
    import torch

    from repro_torch.kernels.trend_scan import (pair_stats,
                                                pair_stats_plain,
                                                trend_scan, trend_scan_plain)

    scan_cases, lengths = _scan_cases(device, scale, seed)
    _check_scan(scan_cases)
    q_fid = scan_cases["fidelity"]
    z_fid = _centered_trends(q_fid, lengths, 60)
    pair_cases = _pair_cases(device, seed, z_fid)
    err, scaled_err = _check_pairs(pair_cases)

    S, N = q_fid.shape
    rows = {"trend_scan": dict(
        ms=_time_ms(lambda: trend_scan(q_fid), timing_reps),
        plain_ms=_time_ms(lambda: trend_scan_plain(q_fid), plain_reps),
        library_ms=_time_ms(lambda: torch.cumsum(q_fid, 1,
                                                 dtype=torch.int32),
                            timing_reps),
        max_abs_err=0.0, shape=f"S={S} N={N} (fidelity, max_range "
                               f"{max(SWEEP_RANGES)})",
        kernels_per_call=_kernels_per_call("trend_scan",
                                           lambda: trend_scan(q_fid)))}
    rows["trend_scan"]["bound_ms"], rows["trend_scan"]["bound_by"] = \
        _bound_ms(S * N * 8, S * N)
    q_week = scan_cases["week"]
    rows["trend_scan"]["week"] = dict(
        ms=_time_ms(lambda: trend_scan(q_week), timing_reps),
        library_ms=_time_ms(lambda: torch.cumsum(q_week, 1,
                                                 dtype=torch.int32),
                            timing_reps),
        bound_ms=_bound_ms(q_week.numel() * 8, q_week.numel())[0],
        shape=f"S=1 N={q_week.shape[1]}")

    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # the yardstick in f32
    try:
        for case in ("fidelity", "S37", "S2_K1024", "S2_K4096"):
            x = pair_cases[case]
            S, K = x.shape
            row = dict(
                ms=_time_ms(lambda: pair_stats(x), timing_reps),
                plain_ms=_time_ms(lambda: pair_stats_plain(x), plain_reps),
                library_ms=_time_ms(lambda: x @ x.T, timing_reps),
                shape=f"S={S} K={K}")
            row["bound_ms"], row["bound_by"] = _bound_ms(
                S * K * 4 + S * 4 + S * S * 4, S * (S + 1) * K + S * K)
            if case == "fidelity":
                rows["pair_stats"] = dict(
                    row, max_abs_err=err, max_scaled_err=scaled_err,
                    kernels_per_call=_kernels_per_call(
                        "pair_stats", lambda: pair_stats(x)))
            else:
                rows["pair_stats"][case] = row
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    return rows


# ------------------------------------------------------- B6 and B7 (phase 3)
def _prefix_count(ss, lengths, below: int):
    """Per-row count of the valid leading stamps below ``below`` (the
    stamps are sorted, so these are a prefix)."""
    import torch
    i = torch.arange(ss.shape[1], device=ss.device)[None, :]
    valid = i < lengths.to(ss.device)[:, None]
    return ((ss < below) & valid).sum(dim=1).to(torch.int32)


def _b6_timing_cases(main, sweep):
    """B6's inputs (stamps, lengths, base, buckets) at the shapes the
    chunked paths give it, from B1's and B2's outputs at the run and sweep
    shapes (dicts of ``ss``, ``lengths``, ``kept``, ``totals``): chunk 0
    of the grid (its kept stamps, and all its records) and the day's
    [1800, 2400) s as one row rebased by its first bucket."""
    import torch

    from repro_torch.kernels import ops
    k0 = _prefix_count(sweep["kept"], sweep["totals"], CHUNK_S)
    w0 = min(-(-max(int(k0.max()), 1) // ops.TILE) * ops.TILE,
             sweep["kept"].shape[1])
    chunk_buckets = ops._padded_buckets(CHUNK_S)
    lo = 3 * CHUNK_S
    a = int(_prefix_count(main["ss"], main["lengths"], lo)[0])
    b = int(_prefix_count(main["ss"], main["lengths"], lo + CHUNK_S)[0])
    return {
        "grid_chunk0_kept": (sweep["kept"][:, :w0].contiguous(), k0, 0,
                             chunk_buckets),
        "grid_chunk0_records": (
            sweep["ss"], _prefix_count(sweep["ss"], sweep["lengths"],
                                       CHUNK_S), 0, chunk_buckets),
        "multiday_chunk": (main["ss"][:, a:b].contiguous(),
                           torch.tensor([b - a], dtype=torch.int32,
                                        device=main["ss"].device), lo,
                           chunk_buckets),
    }


def _kept_stamps(ss, idx, totals):
    """The kept-stamp matrix as ``nsa_sweep_device`` hands it to B3: the
    first TILE-rounded max(totals) columns of the gathered stamps."""
    import torch

    from repro_torch.kernels import ops
    width = min(-(-max(int(totals.max()), 1) // ops.TILE) * ops.TILE,
                ss.shape[1])
    return torch.gather(ss, 1, torch.clamp(
        idx[:, :width], max=ss.shape[1] - 1).long()).contiguous()


def _carry_err(name: str, got, want) -> float:
    """B6's running sums against the plain version's, within MOMENT_RTOL."""
    return _moments_err(name, got[:, ::2], want[:, ::2])


def _carry_state(rng, device, S: int, zero: bool = False):
    """A Kahan carry ``(S, 4)`` on ``device``: zeros, or random sums and
    compensations."""
    import torch
    c = np.zeros((S, 4), np.float32) if zero else np.stack(
        [rng.uniform(0, 5e5, S), rng.uniform(-1, 1, S),
         rng.uniform(0, 5e8, S), rng.uniform(-64, 64, S)],
        axis=1).astype(np.float32)
    return torch.from_numpy(c).to(device)


def _b6_cases(device: str, seed: int, cases):
    """B6's cases, (stamps, lengths, base, buckets): the chunked paths'
    shapes (:func:`_b6_timing_cases`), the ragged batch with an empty row,
    unsorted stamps around a chunk and a chunk of width 0."""
    import torch

    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    sweep, main, ragged = cases["sweep"], cases["main"], cases["ragged"]
    b6 = _b6_timing_cases(main, sweep)
    lo, chunk_buckets = b6["multiday_chunk"][2:]
    rs, rl = ragged["ss"], ragged["lengths"]
    b6["ragged"] = (torch.cat([rs, rs[:1]]).contiguous(),
                    torch.cat([rl, torch.zeros_like(rl[:1])]), 0,
                    ops._padded_buckets(3600))
    # unsorted stamps around the chunk [lo, lo + 600): some below its base,
    # some past base + buckets, ragged lengths with an empty row; and a
    # chunk of width 0
    b6["unsorted_base"] = (
        torch.from_numpy(rng.integers(lo - 300, lo + chunk_buckets + 400,
                                      (4, 70_001), dtype=np.int32)).to(device),
        torch.tensor([70_001, 5, 0, 69_999], dtype=torch.int32,
                     device=device), lo, chunk_buckets)
    b6["width0"] = (torch.zeros((3, 0), dtype=torch.int32, device=device),
                    torch.zeros(3, dtype=torch.int32, device=device), lo,
                    chunk_buckets)
    return b6


def _check_b6(b6, device: str, seed: int, config=None) -> float:
    """B6 (the instance ``config`` names) against its plain version at the
    same bucket block under zero and random carries, a zero carry equal to
    B3 of the same instance bit for bit, two calls in a row bit-identical,
    a smaller call after the largest; returns the largest difference of
    the running sums."""
    from repro_torch.kernels.metrics_fused import (bucket_block_of,
                                                   stream_metrics,
                                                   stream_metrics_carry,
                                                   stream_metrics_carry_plain)
    rng = np.random.default_rng(seed)
    block = bucket_block_of(config)

    def run(ss, lens, buckets, mcar, base):
        return stream_metrics_carry(ss, lens, buckets, mcar, base,
                                    config=config)

    def plain(ss, lens, buckets, mcar, base):
        return stream_metrics_carry_plain(ss, lens, buckets, mcar, base,
                                          bucket_block=block)

    err = 0.0
    for case, (ss, lens, base, buckets) in b6.items():
        S = ss.shape[0]
        for label, mcar in (("zero", _carry_state(rng, device, S, True)),
                            ("random", _carry_state(rng, device, S))):
            hist, mom = run(ss, lens, buckets, mcar, base)
            hist_p, mom_p = plain(ss, lens, buckets, mcar, base)
            _exact(f"stream_metrics_carry/{case}/{label}/hist", hist, hist_p)
            err = max(err, _carry_err(f"stream_metrics_carry/{case}/{label}",
                                      mom, mom_p))
        # a zero carry is B3 on the rebased stamps, bit for bit
        hist, mom = run(ss, lens, buckets,
                        _carry_state(rng, device, S, True), base)
        h3, m3 = stream_metrics((ss - base).contiguous(), lens, buckets,
                                config=config)
        _exact(f"stream_metrics_carry/{case}/b3_hist", hist, h3)
        _exact(f"stream_metrics_carry/{case}/b3_moments",
               mom[:, ::2].contiguous(), m3)
        mcar = _carry_state(rng, device, S)
        _same_twice(f"stream_metrics_carry/{case}",
                    lambda: run(ss, lens, buckets, mcar, base))
    # a smaller call after the largest (the grid's records) reuses its
    # workspace
    ss, lens, base, buckets = b6["multiday_chunk"]
    mcar = _carry_state(rng, device, ss.shape[0])
    hist, mom = run(ss, lens, buckets, mcar, base)
    hist_p, mom_p = plain(ss, lens, buckets, mcar, base)
    _exact("stream_metrics_carry/multiday_chunk after records/hist", hist,
           hist_p)
    _carry_err("stream_metrics_carry/multiday_chunk after records", mom,
               mom_p)
    return err


def _b7_cases(device: str, seed: int):
    """B7's cases, (counts, init): the multi-day path's 659-entry chunk,
    the fidelity shape, widths 0, 1 and 1025 and a 604 800-entry row whose
    seeded total ends just under 2^31 - 1."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.streamsim import per_second_counts
    rng = np.random.default_rng(seed + 1)

    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    day = per_second_counts(_streams(MAIN_SCALE, seed)[0][MAIN_DATASET])
    day = day.astype(np.int32)               # a day's per-second counts
    q_np = rng.poisson(120.0, (6, 87_040)).astype(np.int32)
    ext_lo = 3 * CHUNK_S
    return {
        # trend_scan_chunk's input on the multi-day path: the window tail
        # and one chunk of counts, seeded with the total before them
        "multiday_ext": (up(day[None, ext_lo - TREND_WINDOW + 1:
                               ext_lo + CHUNK_S]),
                         up(np.array([day[:ext_lo - TREND_WINDOW + 1].sum()],
                                     np.int32))),
        "fidelity": (ops._pad_cols(up(q_np), ops.TILE),
                     up(rng.integers(0, 10 ** 6, len(q_np)).astype(
                         np.int32))),
        "width0": (up(np.zeros((3, 0), np.int32)),
                   up(np.array([1, 2, 3], np.int32))),
        "width1": (up(np.array([[7], [9]], np.int32)),
                   up(np.array([0, 11], np.int32))),
        "width1025": (up(rng.poisson(9.0, (2, 1025)).astype(np.int32)),
                      up(np.array([5, 2 ** 30], np.int32))),
        "near_limit": (up(np.full((1, 604_800), 3550, np.int32)),
                       up(np.array([2 ** 31 - 1 - 604_800 * 3550 - 5],
                                   np.int32))),
    }


def _check_b7(b7, config=None) -> None:
    """B7 (the instance ``config`` names) bit-equal to its plain version,
    tail included, at every case; ``init = 0`` equal to B4 of the same
    instance; two calls in a row bit-identical; a smaller call after a
    larger one."""
    import torch

    from repro_torch.kernels.trend_scan import (trend_scan, trend_scan_carry,
                                                trend_scan_carry_plain)

    def run(q, init):
        return trend_scan_carry(q, init, config=config)

    for case, (q, init) in b7.items():
        psum, tail = run(q, init)
        psum_p, tail_p = trend_scan_carry_plain(q, init)
        _exact(f"trend_scan_carry/{case}/psum", psum, psum_p)
        _exact(f"trend_scan_carry/{case}/tail", tail, tail_p)
        _same_twice(f"trend_scan_carry/{case}", lambda: run(q, init))
        if q.shape[1]:
            z, _ = run(q, torch.zeros_like(init))
            _exact(f"trend_scan_carry/{case}/b4", z,
                   trend_scan(q, config=config))
    _, tail = run(*b7["near_limit"])
    if int(tail[0]) != 2 ** 31 - 6:
        raise AssertionError("trend_scan_carry/near_limit: wrong tail")
    # a smaller call after a larger one reuses the larger workspace
    psum, tail = run(*b7["multiday_ext"])
    psum_p, tail_p = trend_scan_carry_plain(*b7["multiday_ext"])
    _exact("trend_scan_carry/multiday_ext after near_limit/psum", psum,
           psum_p)
    _exact("trend_scan_carry/multiday_ext after near_limit/tail", tail,
           tail_p)


def check_carry_kernels(device: str, seed: int, cases,
                        timing_reps: int = 20, plain_reps: int = 3):
    """Phase 3 for B6 and B7: each against its plain version at every case,
    B6 with a zero carry against B3 and B7 with ``init = 0`` against B4 bit
    for bit; returns their timing rows at the shapes the chunked path gives
    them. ``cases`` holds B1's and B2's outputs kept by
    :func:`check_kernels`."""
    import torch

    from repro_torch.kernels.metrics_fused import (stream_metrics_carry,
                                                   stream_metrics_carry_plain)
    from repro_torch.kernels.trend_scan import (trend_scan_carry,
                                                trend_scan_carry_plain)
    rng = np.random.default_rng(seed)

    def carry(S, zero=False):
        return _carry_state(rng, device, S, zero)

    b6 = _b6_cases(device, seed, cases)
    err = _check_b6(b6, device, seed)

    def b6_row(case):
        ss, lens, base, buckets = b6[case]
        S = ss.shape[0]
        mcar = carry(S)
        n_valid = int(lens.sum())
        row = ss[0, :int(lens[0])] - base
        out = dict(
            ms=_time_ms(lambda: stream_metrics_carry(ss, lens, buckets, mcar,
                                                     base), timing_reps),
            plain_ms=_time_ms(lambda: stream_metrics_carry_plain(
                ss, lens, buckets, mcar, base), plain_reps),
            library_ms=_time_ms(lambda: torch.bincount(row,
                                                       minlength=buckets),
                                timing_reps),
            host_ms=_enqueue_ms(lambda: stream_metrics_carry(
                ss, lens, buckets, mcar, base), timing_reps),
            shape=f"S={S} N={ss.shape[1]} B={buckets} counted={n_valid}")
        out["bound_ms"], out["bound_by"] = _bound_ms(
            n_valid * 4 + S * 4 + S * 16 + S * buckets * 4 + S * 16,
            n_valid * 3 + S * buckets * 4)
        return out

    ss, lens, base, buckets = b6["grid_chunk0_kept"]
    mcar = carry(ss.shape[0])
    rows = {"stream_metrics_carry": dict(
        b6_row("grid_chunk0_kept"), max_abs_err=err,
        records=b6_row("grid_chunk0_records"),
        multiday=b6_row("multiday_chunk"),
        kernels_per_call=_kernels_per_call(
            "stream_metrics_carry",
            lambda: stream_metrics_carry(ss, lens, buckets, mcar, base)))}

    b7 = _b7_cases(device, seed)
    _check_b7(b7)

    def b7_row(case):
        q, init = b7[case]
        S, N = q.shape
        out = dict(
            ms=_time_ms(lambda: trend_scan_carry(q, init), timing_reps),
            plain_ms=_time_ms(lambda: trend_scan_carry_plain(q, init),
                              plain_reps),
            library_ms=_time_ms(lambda: torch.cumsum(q, 1,
                                                     dtype=torch.int32),
                                timing_reps),
            shape=f"S={S} N={N}")
        out["bound_ms"], out["bound_by"] = _bound_ms(S * N * 8 + S * 8,
                                                     S * N)
        return out

    rows["trend_scan_carry"] = dict(
        b7_row("multiday_ext"), max_abs_err=0.0, fidelity=b7_row("fidelity"),
        kernels_per_call=_kernels_per_call(
            "trend_scan_carry",
            lambda: trend_scan_carry(*b7["multiday_ext"])))
    return rows


# ----------------------------------------- the tile instances (phase 3)
#: the families of kernels/tuning.py and the kernels (wrapper names) each
#: covers
TUNED = {"stream_sample": ("stream_sample",), "compact": ("compact",),
         "metrics_fused": ("metrics_fused", "stream_metrics_carry"),
         "trend_scan": ("trend_scan", "trend_scan_carry"),
         "pair_stats": ("pair_stats",)}


def _label(kernel: str, cfg) -> str:
    """An instance's name in the tuning line: its record tile, its bucket
    block (B3/B6: both), or "default" for the default library."""
    if cfg is None:
        return "default"
    if kernel == "pair_stats":
        return str(cfg.bucket_block)
    if kernel == "metrics_fused":
        return f"{cfg.record_tile}/{cfg.bucket_block}"
    return str(cfg.record_tile)


def _non_default(kernel: str):
    """The family's configs whose instance is not its default library's:
    every B2 tile (each a library of its one tile), every B5 quantum but
    the default, and the other families' non-default tiles."""
    from repro_torch.kernels import compact, metrics_fused, stream_sample
    from repro_torch.kernels import trend_scan, tuning
    nd = {"stream_sample": lambda c: stream_sample.defines(c),
          "compact": lambda c: True,
          "metrics_fused": lambda c: metrics_fused.defines(c),
          "trend_scan": lambda c: trend_scan.defines(c),
          "pair_stats": lambda c: c.bucket_block != trend_scan.PAIR_QUANTUM}
    return [c for c in tuning.instances(kernel) if nd[kernel](c)]


def _library_tiles(kernel: str, cfg):
    """What the instance's library says its tiles are (proof that the
    macros reached the build), or None for B5 (a runtime quantum)."""
    from repro_torch.kernels import _build, metrics_fused, stream_sample
    from repro_torch.kernels import trend_scan

    def ask(name, symbol, defs):
        return _build.bind(name, symbol, [], defs)()

    if kernel == "stream_sample":
        return ask(kernel, "stream_sample_record_tile",
                   stream_sample.defines(cfg)), cfg.record_tile
    if kernel == "compact":
        defs = (("REPRO_RECORD_TILE", cfg.record_tile),)
        return (ask(kernel, "compact_tile_records", defs),
                ask(kernel, "compact_large_tile_records", defs)), \
            (cfg.record_tile, cfg.record_tile)
    if kernel == "metrics_fused":
        defs = metrics_fused.defines(cfg)
        return (ask(kernel, "metrics_record_tile", defs),
                ask(kernel, "metrics_bucket_block", defs)), \
            (cfg.record_tile, cfg.bucket_block)
    if kernel == "trend_scan":
        return ask(kernel, "trend_scan_tile_entries",
                   trend_scan.defines(cfg)), cfg.record_tile
    return None


def check_instances(device: str, scale: float, seed: int, cases,
                    timing_reps: int = 20):
    """Phase 3 for the tile instances of kernels/tuning.py: each library
    reports the tiles its macros asked for; every non-default instance of
    every family is held to its plain version (at the instance's bucket
    block) at the edge shapes of the default's checks -- B1 and B2 at
    their edges (:func:`check_sample_compact_edges`), B3 on unsorted rows,
    B6 under zero and random carries, B4 and B7 up to totals near 2^31,
    B5 at S = 1 to 130 and K = 0 and 1025 -- and launches one device
    kernel per call; then every instance, the default included, is timed
    at the run and sweep shapes (B3 also the original stream, B6 and B7
    the chunked paths', B4 the week row, B5 S = 37 and the task bench's
    S = 2). ``cases`` holds B1's inputs and outputs kept by
    :func:`check_kernels`. Returns ``{"checked", "kernels_per_call",
    "times"}``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.compact import compact
    from repro_torch.kernels.metrics_fused import (stream_metrics,
                                                   stream_metrics_carry)
    from repro_torch.kernels.stream_sample import stream_sample
    from repro_torch.kernels.trend_scan import (pair_stats, trend_scan,
                                                trend_scan_carry)
    from repro_torch.streamsim.metrics import _bucket_series

    checked = {k: [_label(k, c) for c in _non_default(k)] for k in TUNED}
    for kernel in TUNED:
        for cfg in _non_default(kernel):
            tiles = _library_tiles(kernel, cfg)
            if tiles is not None and tiles[0] != tiles[1]:
                raise AssertionError(f"{kernel}/{_label(kernel, cfg)}: the "
                                     f"library reports tiles {tiles[0]}")

    # the edges, instance by instance
    for cfg in _non_default("stream_sample"):
        check_sample_compact_edges(device, scale, seed, b1_config=cfg)
    for cfg in _non_default("compact"):
        check_sample_compact_edges(device, scale, seed, b2_config=cfg)
    main, sweep = cases["main"], cases["sweep"]
    b_orig, tr = _bucket_series(_streams(scale, seed)[0][MAIN_DATASET],
                                None, None)
    width = -(-len(b_orig) // ops.TILE) * ops.TILE
    sim_buckets = ops._padded_buckets(MAIN_RANGE)
    smaller = (main["kept"], main["totals"], sim_buckets)
    b6 = _b6_cases(device, seed, cases)
    for cfg in _non_default("metrics_fused"):
        _check_unsorted_b3(device, seed, b_orig, width, smaller, cfg)
        _check_b6(b6, device, seed, cfg)
    scan_cases, lengths = _scan_cases(device, scale, seed)
    b7 = _b7_cases(device, seed)
    for cfg in _non_default("trend_scan"):
        _check_scan(scan_cases, cfg)
        _check_b7(b7, cfg)
    z_fid = _centered_trends(scan_cases["fidelity"], lengths, 60)
    pair_cases = _pair_cases(device, seed, z_fid)
    for cfg in _non_default("pair_stats"):
        _check_pairs(pair_cases, cfg)

    # each instance's inputs at the timed shapes
    ssb, lens_o, _ = ops.stream_metrics_inputs([b_orig], tr)
    ss_o, len_o = (torch.from_numpy(x).to(device) for x in (ssb, lens_o))
    rng = np.random.default_rng(seed)
    carry = {c: _carry_state(rng, device, b6[c][0].shape[0])
             for c in ("grid_chunk0_kept", "multiday_chunk")}

    def calls(kernel, cfg):
        """{shape: zero-argument call} of one instance."""
        block = 512 if cfg is None else cfg.bucket_block
        if kernel == "stream_sample":
            return {s: (lambda a=c["b1_in"]: stream_sample(*a, config=cfg))
                    for s, c in (("run", main), ("sweep", sweep))}
        if kernel == "compact":
            return {s: (lambda m=c["keep"]: compact(m, config=cfg))
                    for s, c in (("run", main), ("sweep", sweep))}
        if kernel == "metrics_fused":
            def b3(ss, tot, buckets):
                b = ops._padded_buckets(buckets, block)
                return lambda: stream_metrics(ss, tot, b, config=cfg)

            def b6_call(case):
                ss, lens, base, buckets = b6[case]
                return lambda: stream_metrics_carry(
                    ss, lens, buckets, carry[case], base, config=cfg)

            return {"original": b3(ss_o, len_o, tr),
                    "sim": b3(main["kept"], main["totals"], MAIN_RANGE),
                    "sweep": b3(sweep["kept"], sweep["totals"], MAIN_RANGE),
                    "carry_grid_chunk0": b6_call("grid_chunk0_kept"),
                    "carry_multiday_chunk": b6_call("multiday_chunk")}
        if kernel == "trend_scan":
            return {"fidelity": lambda: trend_scan(scan_cases["fidelity"],
                                                   config=cfg),
                    "week": lambda: trend_scan(scan_cases["week"],
                                               config=cfg),
                    "carry_multiday_ext": lambda: trend_scan_carry(
                        *b7["multiday_ext"], config=cfg),
                    "carry_fidelity": lambda: trend_scan_carry(
                        *b7["fidelity"], config=cfg)}
        return {s: (lambda x=pair_cases[s]: pair_stats(x, config=cfg))
                for s in ("fidelity", "S37", "S2_K4096")}

    times, per_call = {}, {}
    for kernel in TUNED:
        times[kernel] = {}
        for cfg in [None, *_non_default(kernel)]:
            label = _label(kernel, cfg)
            fns = calls(kernel, cfg)
            times[kernel][label] = {s: _time_ms(fn, timing_reps)
                                    for s, fn in fns.items()}
            if cfg is None:
                continue
            # one device kernel a call: the family's first shape, and its
            # carry kernel's (B6, B7)
            carry_shapes = [s for s in fns if s.startswith("carry_")]
            for shape in [next(iter(fns)), *carry_shapes[:1]]:
                per_call[f"{kernel}/{label}/{shape}"] = _kernels_per_call(
                    f"{kernel}/{label}", fns[shape])
    return {"checked": checked, "kernels_per_call": per_call,
            "times": times}


def time_instances_chunk(b1_in, timing_reps: int = 20):
    """B1's and B2's instances at one nine-day chunk (the shape of 54 of
    their 63 launches on the multi-day path), each held to its plain
    version there; returns ``{family: {label: ms}}``."""
    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    ss_p, keep = stream_sample_plain(*b1_in)
    idx_p, tot_p = compact_plain(keep)
    out = {"stream_sample": {}, "compact": {}}
    for cfg in [None, *_non_default("stream_sample")]:
        ss, k = stream_sample(*b1_in, config=cfg)
        _exact("stream_sample/chunk/ss", ss, ss_p)
        _exact("stream_sample/chunk/keep", k, keep)
        out["stream_sample"][_label("stream_sample", cfg)] = _time_ms(
            lambda: stream_sample(*b1_in, config=cfg), timing_reps)
    for cfg in [None, *_non_default("compact")]:
        idx, tot = compact(keep, config=cfg)
        _exact("compact/chunk/idx", idx, idx_p)
        _exact("compact/chunk/totals", tot, tot_p)
        out["compact"][_label("compact", cfg)] = _time_ms(
            lambda: compact(keep, config=cfg), timing_reps)
    return out


# ----------------------------------------------------------- B8 (phase 3)
#: (rtol, atol) of B8 against its plain version: f32 as the JAX
#: flash-decode tests; bf16 one output rounding (2^-7 relative at most)
#: and twice the largest absolute difference measured on the H100 (1.95e-3),
#: well below a typical output at recurrentgemma's full ring (~0.036)
DECODE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 4e-3)}
#: B8's timing shape: the decode_32k cache length of configs/__init__.py
#: with llama3-8b's heads, the batch cut from 128 to 16 (one layer's K and
#: V are then 2.15 GB)
DECODE_TIMING = dict(B=16, S=32_768, H=32, Kh=8, D=128)
#: recurrentgemma-2b's local layers at serving batch (8 slots): a full
#: 2048-slot ring, 10 query heads over one KV head, head_dim 256, bf16
DECODE_RING = dict(B=8, S=2048, H=10, Kh=1, D=256)


def _decode_inputs(gen, B, S, H, Kh, D, dtype, lengths, device):
    import torch
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
               for shape in ((B, H, D), (B, S, Kh, D), (B, S, Kh, D)))
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=device)


def _decode_err(name: str, got, want, dtype: str) -> float:
    import torch
    rtol, atol = DECODE_TOL[dtype]
    if got.dtype != want.dtype or got.shape != want.shape or not \
            torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel and plain version differ by "
                             f"{(got.float() - want.float()).abs().max()} "
                             f"(rtol {rtol}, atol {atol})")
    return float((got.float() - want.float()).abs().max())


def _decode_faults(q, k, v, lengths, got):
    """Outputs of B8 with planted faults, from the plain version on the
    same inputs: the second 64-position tile skipped, the second group
    slice fed the first slice's query rows (two slices of G / 2), and the
    softmax scaled by 1/sqrt(D / 2). :func:`_decode_err` must reject each
    one on the rows that span the whole cache alone, where the softmax is
    spread widest and the outputs are smallest; returns the faults'
    largest absolute differences from ``got`` on those rows."""
    import torch

    from repro_torch.kernels.flash_decode import flash_decode_plain
    ln = lengths.long()
    skip = torch.cat([k[:, :64], k[:, 128:]], 1), \
        torch.cat([v[:, :64], v[:, 128:]], 1)
    short = torch.where(ln > 128, ln - 64, ln.clamp(max=64)).to(torch.int32)
    B, H, D = q.shape
    G = H // k.shape[2]
    q2 = q.reshape(B, -1, G, D).clone()
    q2[:, :, G // 2:2 * (G // 2)] = q2[:, :, :G // 2]
    faults = {"skipped_tile": flash_decode_plain(q, *skip, short),
              "wrong_group_slice": flash_decode_plain(
                  q2.reshape(B, H, D), k, v, lengths),
              "wrong_scale": flash_decode_plain(
                  (q.float() * 2 ** 0.5).to(q.dtype), k, v, lengths)}
    full = (ln >= k.shape[1]).nonzero().flatten()
    got = got[full]
    out = {}
    for name, bad in faults.items():
        bad = bad[full]
        try:
            _decode_err(name, bad, got, str(q.dtype).split(".")[-1])
        except AssertionError:
            out[name] = float((bad.float() - got.float()).abs().max())
            continue
        raise AssertionError(f"flash_decode: the gate passes a planted "
                             f"fault ({name})")
    return out


def _decode_bound(lengths, S, H, Kh, D, itemsize):
    """K and V bytes below each length (read once), q and the output, and
    4 flops per (head, position, d) plus one exp per (head, position)."""
    n = sum(min(int(x), S) for x in lengths)
    B = len(lengths)
    return _bound_ms(2 * n * Kh * D * itemsize + 2 * B * H * D * itemsize
                     + 4 * B, n * H * (4 * D + 1))


def check_decode_kernel(device: str, seed: int, timing_reps: int = 20,
                        plain_reps: int = 3):
    """Phase 3 for B8: the kernel against its plain version within
    :data:`DECODE_TOL` at every (dtype, head_dim, group) the main paths
    give it (the consumer LM's f32 G 3 D 64; llama3-8b's, llama4-scout's
    and command-r+'s bf16 D 128 at G 4, 5 and 12; recurrentgemma's bf16
    D 256 G 10 at S 512 and 2048; the smoke configs' D 16 at G 1, 2 and
    4), ragged lengths with 1, S a multiple of no block, lengths past S,
    and junk past the length (bit-equal outputs); planted faults the gate
    must reject at recurrentgemma's full ring (:func:`_decode_faults`);
    then the timing rows at :data:`DECODE_TIMING`, the serve shape and
    :data:`DECODE_RING` with SDPA as the library yardstick."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cases = {
        # name: (B, S, H, Kh, D, dtype, lengths)
        "consumer_f32": (8, 64, 12, 4, 64, "float32",
                         [1, 2, 9, 17, 33, 63, 64, 40]),
        "llama3_bf16": (8, 512, 32, 8, 128, "bfloat16",
                        [1, 16, 17, 31, 100, 256, 511, 512]),
        "ragged_s_f32": (3, 1000, 12, 4, 64, "float32", [1, 999, 1000]),
        "ragged_s_bf16": (5, 777, 32, 8, 128, "bfloat16",
                          [1, 64, 65, 700, 777]),
        "past_s": (4, 300, 32, 8, 128, "bfloat16", [301, 1000, 2 ** 30, 300]),
        "mha_f32": (2, 130, 4, 4, 64, "float32", [130, 129]),
        # recurrentgemma-2b's local layers (G = 10 in two group slices,
        # D = 256) at phase 17's max_len and at the full ring
        "recurrentgemma_s512": (8, 512, 10, 1, 256, "bfloat16",
                                [1, 17, 64, 65, 200, 300, 511, 512]),
        "recurrentgemma_s2048": (8, 2048, 10, 1, 256, "bfloat16",
                                 [1, 100, 777, 1500, 2047, 2048, 2048,
                                  3000]),
        # command-r-plus-104b: 96 query heads over 8 (G = 12)
        "command_r_plus": (4, 512, 96, 8, 128, "bfloat16",
                           [1, 100, 300, 512]),
        # llama4-scout-17b-a16e at phase 17's serving cache: 40 query heads
        # over 8 (G = 5)
        "llama4_scout": (8, 512, 40, 8, 128, "bfloat16",
                         [1, 17, 20, 24, 31, 64, 300, 512]),
        # the smoke configs: D = 16 in f32 (G = 2, llama3's and
        # llama4-scout's; G = 4, recurrentgemma's; G = 1) and in bf16
        "smoke_f32_d16": (4, 40, 8, 4, 16, "float32", [1, 16, 33, 40]),
        "smoke_f32_d16_g4": (3, 24, 4, 1, 16, "float32", [1, 12, 24]),
        "smoke_f32_d16_g1": (2, 30, 4, 4, 16, "float32", [7, 30]),
        "smoke_bf16_d16": (2, 24, 4, 1, 16, "bfloat16", [5, 24]),
    }
    #: the cases also counted as one device kernel a call
    per_call = ("recurrentgemma_s512", "recurrentgemma_s2048",
                "command_r_plus", "llama4_scout", "smoke_f32_d16")
    faults = {}
    kernels_per_call = {}
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for name, (B, S, H, Kh, D, dtype, lengths) in cases.items():
        q, k, v, lens = _decode_inputs(gen, B, S, H, Kh, D, dtype, lengths,
                                       device)
        got = flash_decode(q, k, v, lens)
        errs[dtype] = max(errs[dtype], _decode_err(
            f"flash_decode/{name}", got, flash_decode_plain(q, k, v, lens),
            dtype))
        if name == "recurrentgemma_s2048":
            faults = _decode_faults(q, k, v, lens, got)
        if name == "past_s":
            full = flash_decode(q, k, v, torch.full_like(lens, S))
            if not torch.equal(got, full):
                raise AssertionError("flash_decode/past_s: lengths > S "
                                     "differ from lengths = S")
        _same_twice(f"flash_decode/{name}",
                    lambda: flash_decode(q, k, v, lens))
        if name in per_call:
            kernels_per_call[name] = _kernels_per_call(
                f"flash_decode/{name}", lambda: flash_decode(q, k, v, lens))
        # junk past the length (prefill padding, or any bits the engine's
        # cache holds there, NaN and inf included) changes nothing
        for junk_k, junk_v in ((999.0, -999.0), (float("nan"), float("inf")),
                               (float("inf"), float("nan"))):
            k2, v2 = k.clone(), v.clone()
            for b, n in enumerate(lengths):
                k2[b, min(n, S):] = junk_k
                v2[b, min(n, S):] = junk_v
            if not torch.equal(flash_decode(q, k2, v2, lens), got):
                raise AssertionError(f"flash_decode/{name}: cache rows past "
                                     f"the length ({junk_k}, {junk_v}) "
                                     "changed the output")
    torch.cuda.synchronize()

    def row(inputs, reps, plain):
        q, k, v, lens = inputs
        (B, H, D), (S, Kh) = q.shape, k.shape[1:3]
        lengths = lens.tolist()
        qs, ks, vs = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(S, device=device)[None, :] <
                lens[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)
        want = flash_decode_plain(q, k, v, lens)
        err = _decode_err(f"flash_decode/timing B={B} S={S}",
                          flash_decode(q, k, v, lens), want, "bfloat16")
        lib_err = float((sdpa()[:, :, 0].float() - want.float()).abs().max())
        out = dict(ms=_time_ms(lambda: flash_decode(q, k, v, lens), reps),
                   plain_ms=(_time_ms(lambda: flash_decode_plain(
                       q, k, v, lens), plain_reps) if plain else None),
                   library_ms=_time_ms(sdpa, reps),
                   library_max_abs_err=lib_err, max_abs_err=err,
                   shape=f"B={B} S={S} H={H} Kh={Kh} D={D} bf16 "
                         f"kept={sum(min(x, S) for x in lengths)}")
        out["bound_ms"], out["bound_by"] = _decode_bound(lengths, S, H, Kh,
                                                         D, 2)
        out["kernels_per_call"] = _kernels_per_call(
            f"flash_decode/B={B} S={S}", lambda: flash_decode(q, k, v, lens))
        return out

    t = DECODE_TIMING
    # the serve_llama3 decode shape: 8 slots of 512 positions, ~20 used
    serve_in = _decode_inputs(gen, 8, 512, t["H"], t["Kh"], t["D"],
                              "bfloat16", [17, 20, 24, 28, 18, 21, 25, 30],
                              device)
    serve_out = flash_decode(*serve_in)
    timed = row(_decode_inputs(gen, t["B"], t["S"], t["H"], t["Kh"], t["D"],
                               "bfloat16", [t["S"]] * t["B"], device),
                timing_reps, True)
    timed["max_abs_err_f32"] = errs["float32"]
    timed["max_abs_err_bf16"] = max(errs["bfloat16"], timed["max_abs_err"])
    timed["max_abs_err"] = max(timed["max_abs_err_f32"],
                               timed["max_abs_err_bf16"])
    # a smaller call after a larger one reuses the larger workspace
    if not torch.equal(flash_decode(*serve_in), serve_out):
        raise AssertionError("flash_decode: the serve shape after the "
                             "decode_32k shape differs from before it")
    timed["serve"] = row(serve_in, timing_reps, True)
    r = DECODE_RING
    timed["recurrentgemma"] = row(_decode_inputs(
        gen, r["B"], r["S"], r["H"], r["Kh"], r["D"], "bfloat16",
        [r["S"]] * r["B"], device), timing_reps, True)
    timed["kernels_per_call_shapes"] = kernels_per_call
    timed["planted_faults_rejected"] = faults
    return {"flash_decode": timed}


def _same_stream(name: str, a, b) -> None:
    """Two streams equal column for column, byte for byte."""
    cols_a = {"t": a.t, "scale_stamp": a.scale_stamp, **a.payload}
    cols_b = {"t": b.t, "scale_stamp": b.scale_stamp, **b.payload}
    if cols_a.keys() != cols_b.keys() or any(
            cols_a[k].dtype != cols_b[k].dtype or
            cols_a[k].tobytes() != cols_b[k].tobytes() for k in cols_a):
        raise AssertionError(f"{name} differs from the reference")


def _same_sim(store_a, store_b, key: str) -> None:
    _same_stream(f"stored sim {key}", store_a.get(key), store_b.get(key))


def _same_report(rep, ref) -> None:
    """Rows equal; trend correlation and volatilities within STAT_TOL."""
    name = f"{rep.dataset}/{rep.max_range}"
    if (rep.original_rows, rep.simulated_rows) != \
            (ref.original_rows, ref.simulated_rows):
        raise AssertionError(f"{name}: row counts differ from numpy")
    if not abs(rep.trend_corr - ref.trend_corr) <= STAT_TOL:
        raise AssertionError(f"{name}: trend_corr {rep.trend_corr} vs "
                             f"numpy {ref.trend_corr}")
    for which in ("original_volatility", "simulated_volatility"):
        va, vb = getattr(rep, which), getattr(ref, which)
        for f in ("average", "variance", "std_variance"):
            x, y = getattr(va, f), getattr(vb, f)
            if not (np.isfinite(x) and
                    abs(x - y) <= STAT_TOL * max(abs(y), 1e-12)):
                raise AssertionError(f"{name}: {which}.{f}: {x} vs numpy "
                                     f"{y}")


# -------------------------------------------------------- phase 4: main path
def run_main_path(device: str, scale: float, seed: int, workdir: Path):
    """Phase 4: ``Controller.run`` through the kernels, with the launch
    counts zeroed just before and read just after, then the same run on
    the numpy backend as the reference."""
    from repro_torch.streamsim import Controller, StreamStore

    wrappers = _wrappers()
    seen = {}

    def consumer(queue):
        n = b = 0
        for bucket in queue:
            n += len(bucket)
            b += 1
        seen["records"], seen["buckets"] = n, b
        return {"records_seen": n}

    ctl = Controller(str(workdir / "torch"), device=device)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rep = ctl.run(MAIN_DATASET, MAIN_RANGE, consumer, scale=scale,
                  seed=seed, backend="torch")
    run_s = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if ctl.last_result.mode != "device":
        raise AssertionError(f"main path ran in {ctl.last_result.mode} mode")
    for name, least in MIN_LAUNCHES.items():
        if launches[name] < least:
            raise AssertionError(f"{name} launched {launches[name]} times on "
                                 f"the main path, expected >= {least}")
    if seen["records"] != rep.simulated_rows:
        raise AssertionError(f"consumer saw {seen['records']} records, "
                             f"report says {rep.simulated_rows}")

    ref_ctl = Controller(str(workdir / "numpy"), device=device)
    t0 = time.perf_counter()
    ref = ref_ctl.run(MAIN_DATASET, MAIN_RANGE, consumer, scale=scale,
                      seed=seed, backend="numpy")
    ref_s = time.perf_counter() - t0
    key = f"{MAIN_DATASET}__sim{MAIN_RANGE}"
    _same_sim(StreamStore(workdir / "torch"), StreamStore(workdir / "numpy"),
              key)
    _same_report(rep, ref)
    report = {
        "dataset": MAIN_DATASET, "max_range": MAIN_RANGE, "scale": scale,
        "original_rows": rep.original_rows,
        "simulated_rows": rep.simulated_rows,
        "consumer_buckets": seen["buckets"],
        "preprocess_s": rep.preprocess_s, "nsa_s": rep.nsa_s,
        "produce_s": rep.produce_s, "run_s": run_s,
        "trend_corr": rep.trend_corr, "trend_corr_numpy": ref.trend_corr,
        "simulated_average": rep.simulated_volatility.average,
        "simulated_std": rep.simulated_volatility.std_variance,
        "numpy_run_s": ref_s, "numpy_nsa_s": ref.nsa_s,
        "numpy_produce_s": ref.produce_s,
    }
    return launches, report


# ------------------------------------------------------ phase 5: the sweep
class _SweepConsumer:
    """Thread-safe consumer for ``run_many``, which drains every scenario's
    queue on its own thread: counts each scenario's records (returned) and
    the sweep's total (under a lock)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = 0
        self.buckets = 0

    def __call__(self, queue):
        n = b = 0
        for bucket in queue:
            n += len(bucket)
            b += 1
        with self.lock:
            self.records += n
            self.buckets += b
        return {"records_seen": n}


def run_sweep_path(device: str, scale: float, seed: int, workdir: Path):
    """Phase 5: ``Controller.run_many`` over the paper's grid in a fresh
    store, with the launch counts zeroed just before and read just after,
    then the same sweep on the numpy backend as the reference."""
    import torch

    from repro_torch.streamsim import Controller, StreamStore, engine

    wrappers = _wrappers()
    fid_s = []
    plain_fidelity = engine.DeviceSweepResult.fidelity

    def timed_fidelity(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return plain_fidelity(self, *args, **kwargs)
        finally:
            fid_s.append(time.perf_counter() - t0)

    engine.DeviceSweepResult.fidelity = timed_fidelity
    try:
        ctl = Controller(str(workdir / "sweep_torch"), device=device)
        consumer = _SweepConsumer()
        torch.cuda.reset_peak_memory_stats()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        reps = ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, consumer,
                            scale=scale, seed=seed, backend="torch")
        run_s = time.perf_counter() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        torch_fid_s = sum(fid_s)
        fid_s.clear()

        if ctl.last_result.mode != "device":
            raise AssertionError(f"sweep ran in {ctl.last_result.mode} mode")
        if len(ctl.last_result.plan.cached) != 0:
            raise AssertionError("sweep store was not fresh")
        for name, least in MIN_SWEEP_LAUNCHES.items():
            if launches[name] < least:
                raise AssertionError(f"{name} launched {launches[name]} "
                                     f"times on the sweep, expected >= "
                                     f"{least}")
        for r in reps:
            if r.consumer_metrics["records_seen"] != r.simulated_rows:
                raise AssertionError(
                    f"{r.dataset}/{r.max_range}: consumer saw "
                    f"{r.consumer_metrics['records_seen']} records, report "
                    f"says {r.simulated_rows}")
        if consumer.records != sum(r.simulated_rows for r in reps):
            raise AssertionError("sweep consumer total differs from reports")

        ref_ctl = Controller(str(workdir / "sweep_numpy"), device=device)
        t0 = time.perf_counter()
        refs = ref_ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, _SweepConsumer(),
                                scale=scale, seed=seed, backend="numpy")
        ref_s = time.perf_counter() - t0
        numpy_fid_s = sum(fid_s)
    finally:
        engine.DeviceSweepResult.fidelity = plain_fidelity

    grid = [(d, mr) for d in SWEEP_DATASETS for mr in SWEEP_RANGES]
    if [(r.dataset, r.max_range) for r in reps] != grid or \
            [(r.dataset, r.max_range) for r in refs] != grid:
        raise AssertionError("sweep reports out of grid order")
    st_a = StreamStore(workdir / "sweep_torch")
    st_b = StreamStore(workdir / "sweep_numpy")
    for (d, mr), rep, ref in zip(grid, reps, refs):
        _same_sim(st_a, st_b, f"{d}__sim{mr}")
        _same_report(rep, ref)
    fid_err = 0.0
    if len(ctl.last_fidelity) != len(SWEEP_RANGES) or \
            len(ref_ctl.last_fidelity) != len(SWEEP_RANGES):
        raise AssertionError("one fidelity matrix per max_range expected")
    for fa, fb in zip(ctl.last_fidelity, ref_ctl.last_fidelity):
        a = np.asarray(fa.trend_corr, float)
        b = np.asarray(fb.trend_corr, float)
        if fa.labels != fb.labels or fa.max_range != fb.max_range or \
                a.shape != (2 * len(SWEEP_DATASETS),) * 2 or \
                not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"fidelity {fa.max_range}: labels, shape "
                                 "or NaN pattern differ from numpy")
        live = ~np.isnan(a)
        fid_err = max(fid_err, float(np.abs(a - b)[live].max(initial=0.0)))
        if fid_err > STAT_TOL:
            raise AssertionError(f"fidelity {fa.max_range}: {fid_err} "
                                 "from numpy")
    sweep = {
        "datasets": list(SWEEP_DATASETS), "max_ranges": list(SWEEP_RANGES),
        "scale": scale, "scenarios": len(reps),
        "original_rows": {d: r.original_rows for d, r in
                          ((r.dataset, r) for r in reps)},
        "simulated_rows": sum(r.simulated_rows for r in reps),
        "consumer_buckets": consumer.buckets,
        "run_s": run_s, "nsa_s": max(r.nsa_s for r in reps),
        "nsa_s_sum": sum(r.nsa_s for r in reps),
        "produce_s": max(r.produce_s for r in reps),
        "fidelity_s": torch_fid_s, "peak_device_bytes": peak,
        "max_fidelity_abs_diff": fid_err,
        "max_trend_corr_abs_diff": max(abs(a.trend_corr - b.trend_corr)
                                       for a, b in zip(reps, refs)),
        "numpy_run_s": ref_s, "numpy_nsa_s": max(r.nsa_s for r in refs),
        "numpy_produce_s": max(r.produce_s for r in refs),
        "numpy_fidelity_s": numpy_fid_s,
    }
    return launches, sweep, (reps, ctl.last_fidelity,
                             ref_ctl.last_fidelity)


def _stat_close(name, got: float, want: float, rtol: float) -> None:
    if not (np.isfinite(got) and abs(got - want) <= rtol * max(abs(want),
                                                                 1e-12)):
        raise AssertionError(f"{name}: {got} vs {want} beyond {rtol}")


def _same_fidelity(name, got, want, n_matrices: int,
                   tol: float = STAT_TOL) -> float:
    """Fidelity matrices with the same labels and NaN pattern, entries
    within ``tol``; returns the largest difference."""
    if len(got) != n_matrices or len(want) != n_matrices:
        raise AssertionError(f"{name}: one fidelity matrix per max_range "
                             "expected")
    worst = 0.0
    for fa, fb in zip(got, want):
        a = np.asarray(fa.trend_corr, float)
        b = np.asarray(fb.trend_corr, float)
        if fa.labels != fb.labels or fa.max_range != fb.max_range or \
                not np.array_equal(np.isnan(a), np.isnan(b)):
            raise AssertionError(f"{name} {fa.max_range}: labels or NaN "
                                 "pattern differ")
        live = ~np.isnan(a)
        worst = max(worst, float(np.abs(a - b)[live].max(initial=0.0)))
    if worst > tol:
        raise AssertionError(f"{name}: fidelity {worst} from the reference")
    return worst


def _bounded_feeds(reps) -> int:
    hwm = max(r.consumer_metrics["feed_hwm_chunks"] for r in reps)
    if hwm > 2:
        raise AssertionError(f"a feed held {hwm} chunks (bound 2)")
    return hwm


# ---------------------------------------------- phase 6: the chunked grid
def run_chunked_path(device: str, scale: float, seed: int, workdir: Path,
                     mono):
    """Phase 6: the paper's grid through the chunked pipeline in a fresh
    store, launch counts zeroed just before and read just after, held to
    phase 5's monolithic torch sweep (``mono`` = its reports and fidelity
    matrices, then its numpy matrices; its store under
    ``workdir/sweep_torch``)."""
    import torch

    from repro_torch.streamsim import Controller, StreamStore

    mono_reps, mono_fid = mono[:2]
    ctl = Controller(str(workdir / "chunked_torch"), device=device)
    consumer = _SweepConsumer()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    reps = ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, consumer, scale=scale,
                        seed=seed, backend="torch", chunk_s=CHUNK_S)
    run_s = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    result = ctl.last_result
    if result.mode != "device":
        raise AssertionError(f"chunked grid ran in {result.mode} mode")
    _check_launches("the chunked grid", launches, CHUNKED_LAUNCHES,
                    exact=True)
    grid = [(d, mr) for d in SWEEP_DATASETS for mr in SWEEP_RANGES]
    if [(r.dataset, r.max_range) for r in reps] != grid:
        raise AssertionError("chunked reports out of grid order")
    st_a = StreamStore(workdir / "chunked_torch")
    st_b = StreamStore(workdir / "sweep_torch")
    vol_err = 0.0
    for (d, mr), rep, ref in zip(grid, reps, mono_reps):
        name = f"chunked {d}/{mr}"
        _same_sim(st_a, st_b, f"{d}__sim{mr}")
        if st_a.manifest(f"{d}__sim{mr}")["chunks"] != -(-mr // CHUNK_S):
            raise AssertionError(f"{name}: not stored in chunks")
        if rep.simulated_rows != ref.simulated_rows or \
                rep.consumer_metrics["records_seen"] != rep.simulated_rows:
            raise AssertionError(f"{name}: rows differ")
        for k, v in ref.consumer_metrics.items():
            if rep.consumer_metrics[k] != v:
                raise AssertionError(f"{name}: consumer stat {k} differs")
        for f in ("average", "variance", "std_variance"):
            x = getattr(rep.simulated_volatility, f)
            y = getattr(ref.simulated_volatility, f)
            _stat_close(f"{name} volatility.{f}", x, y, MOMENT_RTOL)
            vol_err = max(vol_err, abs(x - y) / max(abs(y), 1e-12))
        if abs(rep.trend_corr - ref.trend_corr) > STAT_TOL:
            raise AssertionError(f"{name}: trend_corr {rep.trend_corr} vs "
                                 f"{ref.trend_corr}")
    fid_err = _same_fidelity("chunked grid", ctl.last_fidelity, mono_fid,
                             len(SWEEP_RANGES))
    chunked = {
        "chunk_s": CHUNK_S, "scenarios": len(reps),
        "n_chunks": result.plan.n_chunks,
        "simulated_rows": sum(r.simulated_rows for r in reps),
        "consumer_buckets": consumer.buckets,
        "run_s": run_s, "produce_s": max(r.produce_s for r in reps),
        "nsa_s": max(r.nsa_s for r in reps), "peak_device_bytes": peak,
        "feed_hwm_chunks": _bounded_feeds(reps), **result.pipeline_s,
        "max_volatility_rel_diff": vol_err,
        "max_trend_corr_abs_diff": max(abs(a.trend_corr - b.trend_corr)
                                       for a, b in zip(reps, mono_reps)),
        "max_fidelity_abs_diff": fid_err,
        "tolerances": {"volatility_rel": MOMENT_RTOL, "trend_corr": STAT_TOL,
                       "fidelity": STAT_TOL, "sims": "byte-equal"},
    }
    return launches, chunked


# ---------------------------------------------- phase 7: nine days, chunked
def run_multiday_path(device: str, scale: float, seed: int, workdir: Path):
    """Phase 7: nine days of the userbehavior stream through the chunked
    pipeline, held to the port's numpy backend on the same original; then
    B7 through ``ops.trend_scan_chunk`` over the finalized count row,
    held to B4's monolithic trend bit for bit."""
    import shutil

    import torch

    from repro_torch.kernels import ops
    from repro_torch.streamsim import ChunkedNSA, Controller, StreamStore

    ctl = Controller(str(workdir / "md_torch"), device=device)
    consumer = _SweepConsumer()
    kw = dict(scale=scale, seed=seed, chunk_s=CHUNK_S, duration_s=MULTIDAY_S)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    (rep,) = ctl.run_many((MAIN_DATASET,), (MAIN_RANGE,), consumer,
                          backend="torch", **kw)
    run_s = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    result = ctl.last_result
    if result.mode != "device":
        raise AssertionError(f"multi-day ran in {result.mode} mode")

    # B7 on the finalized count row, one launch per chunk
    q = result.shard_results[0].hist[:1]
    n = q.shape[1]
    _zero_launches()
    segs, tail, total = [], None, None
    t0 = time.perf_counter()
    for lo in range(0, n, CHUNK_S):
        seg, start, tail, total = ops.trend_scan_chunk(
            q[:, lo:lo + CHUNK_S], TREND_WINDOW, tail=tail,
            psum_carry=total, lo=lo, is_last=lo + CHUNK_S >= n)
        segs.append(seg)
    chunked_trend = torch.cat(segs, dim=1)
    torch.cuda.synchronize()
    trend_chunk_s = time.perf_counter() - t0
    launches["trend_scan_carry"] = _read_launches()["trend_scan_carry"]
    _check_launches("the multi-day path", launches, MULTIDAY_LAUNCHES,
                    exact=True)
    mono, _ = ops.trend_scan_batched_device(q, [n], TREND_WINDOW)
    if not torch.equal(chunked_trend, mono[:, :n]):
        raise AssertionError("multi-day: B7 chunks differ from B4's trend")
    if int(total[0]) != rep.simulated_rows:
        raise AssertionError(f"multi-day: B7 total {int(total[0])} vs "
                             f"{rep.simulated_rows} simulated rows")

    # the reference: the port's numpy backend on the SAME original (its
    # store entry copied, so POSD runs once)
    key = f"{MAIN_DATASET}__orig__d{MULTIDAY_S}"
    src_store = StreamStore(workdir / "md_torch")
    ref_store = StreamStore(workdir / "md_numpy")
    shutil.copytree(src_store._dir(key), ref_store._dir(key))
    # B1's inputs for one chunk, as the run's ChunkedNSA built them, for
    # the chunk-shape timings of B1 and B2
    (spec,) = result.plan.scenarios
    lo = MULTIDAY_TIMED_CHUNK * CHUNK_S
    chunk_in, _ = ChunkedNSA({MAIN_DATASET: src_store.get(key)},
                             [(spec.dataset, spec.span_s)],
                             device=device).sample_inputs(lo, lo + CHUNK_S)
    t0 = time.perf_counter()
    (ref,) = Controller(str(workdir / "md_numpy"), device=device).run_many(
        (MAIN_DATASET,), (MAIN_RANGE,), _SweepConsumer(), backend="numpy",
        **kw)
    ref_s = time.perf_counter() - t0
    sim_key = f"{MAIN_DATASET}__sim{MAIN_RANGE}__d{MULTIDAY_S}"
    _same_sim(src_store, ref_store, sim_key)
    _same_report(rep, ref)
    if rep.consumer_metrics["records_seen"] != rep.simulated_rows or \
            ref.consumer_metrics["records_seen"] != ref.simulated_rows:
        raise AssertionError("multi-day: consumer rows differ from reports")
    multiday = {
        "dataset": MAIN_DATASET, "max_range": MAIN_RANGE,
        "duration_s": MULTIDAY_S, "chunk_s": CHUNK_S,
        "n_chunks": result.plan.n_chunks, "span_s": n,
        "original_rows": rep.original_rows,
        "simulated_rows": rep.simulated_rows,
        "consumer_buckets": consumer.buckets,
        "run_s": run_s, "preprocess_s": rep.preprocess_s,
        "produce_s": rep.produce_s, "nsa_s": rep.nsa_s,
        "peak_device_bytes": peak, "feed_hwm_chunks": _bounded_feeds([rep]),
        **result.pipeline_s, "trend_chunks_s": trend_chunk_s,
        "trend_corr": rep.trend_corr, "trend_corr_numpy": ref.trend_corr,
        "numpy_run_s": ref_s, "numpy_produce_s": ref.produce_s,
        "tolerances": {"stats": STAT_TOL, "sims": "byte-equal",
                       "trend_chunks_vs_b4": "bit-equal"},
    }
    return launches, multiday, chunk_in


def check_chunk_shape(b1_in, timing_reps: int = 20, plain_reps: int = 3):
    """B1 and B2 at the shape of a nine-day chunk (B1's inputs for one
    chunk of :func:`run_multiday_path`): bit-equal to their plain
    versions; returns their timing rows."""
    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    ss, keep = stream_sample(*b1_in)
    ss_p, keep_p = stream_sample_plain(*b1_in)
    _exact("stream_sample/chunk/ss", ss, ss_p)
    _exact("stream_sample/chunk/keep", keep, keep_p)
    idx, tot = compact(keep)
    idx_p, tot_p = compact_plain(keep)
    _exact("compact/chunk/idx", idx, idx_p)
    _exact("compact/chunk/totals", tot, tot_p)
    return _b12_timings(b1_in, ss, keep, tot, timing_reps, plain_reps)


# ------------------------------------------------- phase 8: serve (the CLI)
def run_serve_path(workdir: Path, argv=()):
    """Phase 8: ``repro_torch.launch.serve`` at its defaults (the paper's
    consumer LM at full width, sogouq compressed to 120 s at scale 0.01,
    8 slots, max_len 64) with the launch counts zeroed just before and
    read just after: every arrival must finish, and B8 must run once per
    decode step and layer."""
    from repro_torch.configs.paper_stream import consumer_lm
    from repro_torch.launch import serve

    _zero_launches()
    t0 = time.perf_counter()
    summary = serve.main(["--out", str(workdir / "serve_metrics.json"),
                          *argv])
    wall = time.perf_counter() - t0
    launches = _read_launches()
    n_layers = consumer_lm().n_layers
    if summary["finished"] != summary["arrivals"] or summary["arrivals"] < 1:
        raise AssertionError(f"serve: {summary['finished']} of "
                             f"{summary['arrivals']} arrivals finished")
    _check_launches("serve", launches, {
        "flash_decode": summary["decode_steps"] * n_layers}, exact=True)
    return launches, dict(summary, wall_s=wall, layers=n_layers)


# ------------------------------------- phase 9: llama3-8b under Controller.run
SERVE_ARCH, SERVE_DATASET, SERVE_RANGE = "llama3-8b", "sogouq", 120
SERVE_TASK = dict(slots=8, max_len=512, prompt_len=16, max_new_tokens=16,
                  max_requests_per_bucket=4, reuse_engine=True)


def _decode_attention_f64(q, k, v, lengths):
    """B8's function in float64 (a witness for near-ties in the logits:
    the plain version's math with the rounding of f32 taken away),
    returned in q's dtype."""
    import torch
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    qd = q.reshape(B, Kh, H // Kh, D).double()
    scores = torch.einsum("bhgd,bshd->bhgs", qd, k.double()) / D ** 0.5
    mask = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.double())
    return out.reshape(B, H, D).to(q.dtype)


def _decode_attention_sdpa(q, k, v, lengths):
    """B8's function through ``scaled_dot_product_attention`` (a second
    witness, with its own order of rounding)."""
    import torch
    import torch.nn.functional as F
    S = k.shape[1]
    mask = (torch.arange(S, device=q.device)[None, :] <
            lengths[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, enable_gqa=True)[:, :, 0]


def _capture_decode(cfg, params, cache, toks, layers, attn=None):
    """One decode step from a copy of ``cache``; returns its logits and
    the (q, k, v, lengths) B8 was given in ``layers``. With ``attn`` the
    step runs that function in every layer instead of the kernel (the
    swap is this script's, not an option of the package)."""
    import torch

    from repro_torch import tree
    from repro_torch.kernels import ops
    from repro_torch.models import transformer

    real = ops.flash_decode
    seen, calls = {}, [0]

    def hook(q, k, v, lengths, **kw):
        if calls[0] in layers:
            seen[calls[0]] = tuple(t.clone() for t in (q, k, v, lengths))
        calls[0] += 1
        return real(q, k, v, lengths, **kw) if attn is None else \
            attn(q, k, v, lengths)

    work = tree.tree_map(torch.clone, cache)
    ops.flash_decode = hook
    try:
        logits, _ = transformer.decode_step(cfg, params, work, toks)
    finally:
        ops.flash_decode = real
    torch.cuda.synchronize()
    return logits, seen


def _b8_layers(cfg) -> int:
    """Layers whose decode attention runs through B8: GQA, global or
    local (MLA's latent decode is not B8's function)."""
    return 0 if cfg.mla else sum(k.split(":")[0] in ("attn", "local")
                                 for k in cfg.blocks())


def _serve_run(device: str, seed: int, store: Path, name: str, cfg,
               params):
    """``Controller(store).run("sogouq", 120, ServingTask(...))`` with
    :data:`SERVE_TASK`, the launch counts zeroed just before and read just
    after: the run must be in device mode, finish every request, launch
    B8 exactly once per decode step and GQA layer, and B1-B3 at least
    :data:`MIN_LAUNCHES`. Returns (launches, the report, the task, run
    seconds, peak device GB)."""
    import torch

    from repro_torch.streamsim import Controller, ServingTask

    task = ServingTask(cfg, params, device=device, **SERVE_TASK)
    torch.cuda.reset_peak_memory_stats()
    ctl = Controller(str(store), device=device)
    _zero_launches()
    t0 = time.perf_counter()
    rep = ctl.run(SERVE_DATASET, SERVE_RANGE, task, seed=seed)
    run_s = time.perf_counter() - t0
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    m = rep.consumer_metrics
    if ctl.last_result.mode != "device":
        raise AssertionError(f"{name} ran in {ctl.last_result.mode} mode")
    if m["serving_finished"] != m["task_records"] or m["task_records"] < 1:
        raise AssertionError(f"{name}: {m['serving_finished']} of "
                             f"{m['task_records']} requests finished")
    _check_launches(name, launches, {
        "flash_decode": m["serving_decode_steps"] * _b8_layers(cfg)},
        exact=True)
    _check_launches(name, launches, MIN_LAUNCHES, exact=False)
    return launches, rep, task, run_s, peak_gb


def run_serve_llama3_path(device: str, seed: int, workdir: Path,
                          cfg=None, reps: int = 10):
    """Phase 9: ``Controller.run("sogouq", 120, consumer=ServingTask(...))``
    on llama3-8b at its published width (32 layers, d 4096, 32/8 heads,
    head_dim 128, bf16) with seeded random weights on the card, the launch
    counts zeroed just before and read just after. Then, outside the
    counted run: B8 against its plain version on the inputs captured from
    the first and last layers of a real decode step, the logits of that
    step through B8 and through the plain version (reported, not gated)
    with two witnesses of the same step (B8's function in f64 and through
    SDPA), and prefill / decode step times. ``cfg`` replaces llama3-8b (a small
    config rehearses the phase on the CPU)."""
    import gc

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models import transformer

    cfg = get_config(SERVE_ARCH) if cfg is None else cfg
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    if n_params != cfg.n_params():
        raise AssertionError(f"{cfg.name}: {n_params} parameters, the "
                             f"config says {cfg.n_params()}")
    launches, rep, task, run_s, peak_gb = _serve_run(
        device, seed, workdir / "serve_llama3", "serve_llama3", cfg, params)
    m = rep.consumer_metrics

    # outside the counted run: a batch of 8 ragged prompts from a seed
    rng = np.random.default_rng(seed)
    slots, p_len = SERVE_TASK["slots"], SERVE_TASK["prompt_len"]
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (slots, p_len),
                                         dtype=np.int32)).to(device)
    lens = torch.from_numpy(rng.integers(1, p_len + 1, slots,
                                         dtype=np.int32)).to(device)
    max_len = SERVE_TASK["max_len"]

    def prefill():
        return transformer.prefill(cfg, params, toks, lens, max_len)
    prefill_ms = _host_ms(prefill, reps)
    logits, cache = prefill()
    nxt = torch.argmax(logits, -1).to(torch.int32)
    last = cfg.n_layers - 1
    lk, seen = _capture_decode(cfg, params, cache, nxt, (0, last))
    lp, _ = _capture_decode(cfg, params, cache, nxt, (0, last),
                            flash_decode_plain)
    b8_err = 0.0
    for layer, (q, k, v, ln) in sorted(seen.items()):
        b8_err = max(b8_err, _decode_err(
            f"flash_decode/{cfg.name} layer {layer}", flash_decode(q, k, v, ln),
            flash_decode_plain(q, k, v, ln), cfg.dtype))
    top1 = float((torch.argmax(lk, -1) == torch.argmax(lp, -1)).float()
                 .mean())
    # where the two top tokens differ, how far apart the two paths put
    # them: a flip within the paths' logit difference is a near-tie
    # (plain's lead over B8's token in the plain logits, and B8's lead in
    # its own)
    lk2, lp2 = lk.reshape(-1, lk.shape[-1]), lp.reshape(-1, lp.shape[-1])
    tk, tp = torch.argmax(lk2, -1), torch.argmax(lp2, -1)
    flipped = (tk != tp).nonzero().flatten().tolist()
    flip_gaps = [[float(lp2[i, tp[i]] - lp2[i, tk[i]]),
                  float(lk2[i, tk[i]] - lk2[i, tp[i]])] for i in flipped]
    # witnesses: the same step through B8's function in f64 and through
    # SDPA; each one's top-1 agreement with the plain path, and on the
    # rows where B8 and the plain version differ, whose token it picks
    witnesses = {}
    for wname, fn in (("f64", _decode_attention_f64),
                      ("sdpa", _decode_attention_sdpa)):
        lw, _ = _capture_decode(cfg, params, cache, nxt, (), fn)
        tw = torch.argmax(lw.reshape(-1, lw.shape[-1]), -1)
        witnesses[wname] = {
            "top1_vs_plain": float((tw == tp).float().mean()),
            "top1_vs_b8": float((tw == tk).float().mean()),
            "max_abs_logit_diff_vs_plain": float((lw - lp).abs().max()),
            "flipped_rows_pick": ["b8" if tw[i] == tk[i] else "plain"
                                  if tw[i] == tp[i] else "other"
                                  for i in flipped]}
        del lw

    def decode():
        transformer.decode_step(cfg, params, cache, nxt)
    decode_ms = _host_ms(decode, reps)
    report = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim_, "dtype": cfg.dtype, "params": n_params,
        "init_s": init_s, "run_s": run_s,
        "task_records": m["task_records"],
        "serving_finished": m["serving_finished"],
        "serving_tokens_out": m["serving_tokens_out"],
        "serving_decode_steps": m["serving_decode_steps"],
        "serving_queue_peak": m["serving_queue_peak"],
        "task_wall_s": m["task_wall_s"],
        "tokens_per_s": m["serving_tokens_out"] / m["task_wall_s"],
        "simulated_rows": rep.simulated_rows, "produce_s": rep.produce_s,
        "peak_gb": peak_gb, "prefill_ms": prefill_ms,
        "prefill_shape": f"B={slots} P={p_len} max_len={max_len}",
        "decode_step_ms": decode_ms,
        "decode_tokens_per_s": slots * 1e3 / decode_ms,
        "b8_layers_max_abs_err": b8_err,
        "plain_swap_max_abs_logit_diff": float((lk - lp).abs().max()),
        "plain_swap_top1_agreement": top1,
        "plain_swap_flip_gaps": flip_gaps,
        "plain_swap_witnesses": witnesses,
    }
    print(f"serve_llama3: prefill {prefill_ms:.3f} ms "
          f"({report['prefill_shape']})")
    print(f"serve_llama3: decode step {decode_ms:.3f} ms at {slots} slots, "
          f"{report['decode_tokens_per_s']:.1f} tokens/s; "
          f"end to end {report['tokens_per_s']:.1f} tokens/s")
    print(f"serve_llama3: peak device memory {peak_gb:.2f} GB")
    del task, params, cache, logits, lk, lp, seen
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------- the paper's task bench
TASKBENCH_RANGES = (600, 3600)


def _bench_tasks():
    """The reference benchmark's three bucket tasks
    (``benchmarks/bench_PR8.py``): ETL, a 30 s window, and a threshold
    detector."""
    from repro_torch.streamsim import (ETLTask, EventDetectTask,
                                       WindowedStatsTask)
    return [ETLTask(), WindowedStatsTask(window_s=30),
            EventDetectTask(mode="threshold", threshold=4.0)]


def _same_summaries(name, got, want) -> None:
    for g, w in zip(got, want):
        for key, wv in w.to_dict().items():
            gv = g.to_dict()[key]
            if not (gv == wv or (np.isnan(gv) and np.isnan(wv))):
                raise AssertionError(f"{name}: {key} {gv} vs numpy {wv}")
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} summaries, numpy "
                             f"{len(want)}")


def run_taskbench_path(device: str, scale: float, seed: int):
    """The paper's experiment (``TaskBenchRunner``): every bench task over
    the original and the simulated replay of each dataset at each range,
    on the torch backend: per report one S = 2 trend chain (B4, B5), per
    task one latency histogram over its sims' unsorted bins (B3). Checks
    the launches, the record counts, the speedups, the threshold
    detector's device chain against ``backend="numpy"`` on the same output
    series, and the fidelity floor (a detector cell whose float64 numpy
    fidelity is itself below the floor is held to that value instead and
    listed); returns ``(launches, summary)``."""
    import torch

    from repro_torch.streamsim import (FIDELITY_FLOOR, LATENCY_BINS,
                                       EventDetectTask, TaskBenchRunner, nsa,
                                       original_replay_stream,
                                       summarize_latencies,
                                       trend_correlation_matrix)
    from repro_torch.streamsim.engine import replay_many
    from repro_torch.streamsim.taskbench import _hist_rows

    runner = TaskBenchRunner(SWEEP_DATASETS, TASKBENCH_RANGES, scale=scale,
                             seed=seed, device=device, backend="torch")
    tasks = _bench_tasks()
    t0 = time.perf_counter()
    originals, sims = runner._prepare()
    prepare_s = time.perf_counter() - t0
    _zero_launches()
    t0 = time.perf_counter()
    reports = runner.run(tasks)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = _read_launches()
    cells = len(SWEEP_DATASETS) * len(TASKBENCH_RANGES)
    expected = dict.fromkeys(launches, 0)
    expected.update(pair_stats=len(tasks) * cells,
                    trend_scan=len(tasks) * cells, metrics_fused=len(tasks))
    _check_launches("taskbench", launches, expected, exact=True)
    if len(reports) != len(tasks) * cells:
        raise AssertionError(f"taskbench: {len(reports)} reports")
    n_sim = {k: len(nsa(originals[k[0]], k[1]).t) for k in sims}
    for r in reports:
        if not r.speedup > 1.0 or \
                r.records_original != len(originals[r.dataset].t) or \
                r.records_simulated != n_sim[r.dataset, r.max_range]:
            raise AssertionError(
                f"taskbench/{r.task}/{r.dataset}/{r.max_range}: speedup "
                f"{r.speedup}, records {r.records_original}, "
                f"{r.records_simulated}")

    # the detector's output series again (a pure function of the replayed
    # buckets): the device chain against numpy on the same series
    task = EventDetectTask(mode="threshold", threshold=4.0)
    runs = {}
    for ds in SWEEP_DATASETS:
        key = (ds, "original")
        runs[key] = replay_many({key: original_replay_stream(originals[ds])},
                                task, runner.queue_size)[0][key]
    for key in sims:
        runs[key] = replay_many({key: sims[key]}, task,
                                runner.queue_size)[0][key]
    corr_err, numpy_fid = 0.0, {}
    for ds, mr in sims:
        series = [runs[ds, "original"]["task_output_counts"],
                  runs[ds, mr]["task_output_counts"]]
        c_t = trend_correlation_matrix(series, runner.window_s,
                                       backend="torch", device=device)
        c_n = trend_correlation_matrix(series, runner.window_s,
                                       backend="numpy")
        e = float(np.abs(c_t - c_n).max())
        if not e <= STAT_TOL:
            raise AssertionError(f"taskbench/{ds}/{mr}: trend correlation "
                                 f"{c_t[0, 1]} vs numpy {c_n[0, 1]}")
        corr_err = max(corr_err, e)
        numpy_fid[ds, mr] = float(c_n[0, 1])
    # the floor: every report, but a detector cell whose float64 numpy
    # fidelity on the same series (the reference's own convention) is below
    # it too, where the report must equal that value within STAT_TOL
    below = []
    for r in reports:
        name = f"taskbench/{r.task}/{r.dataset}/{r.max_range}"
        if r.task == task.name:
            want = numpy_fid[r.dataset, r.max_range]
            if not abs(r.trend_fidelity - want) <= STAT_TOL:
                raise AssertionError(f"{name}: fidelity {r.trend_fidelity} "
                                     f"vs numpy {want}")
            if want < FIDELITY_FLOOR:
                below.append(dict(task=r.task, dataset=r.dataset,
                                  max_range=r.max_range,
                                  trend_fidelity=r.trend_fidelity,
                                  numpy_fidelity=want))
                continue
        if not r.trend_fidelity >= FIDELITY_FLOOR:
            raise AssertionError(f"{name}: fidelity {r.trend_fidelity} "
                                 f"below {FIDELITY_FLOOR}")
    bins = [np.asarray(runs[k]["task_latency_bins"], np.int32) for k in sims]
    _same_summaries("taskbench/latency",
                    summarize_latencies(bins, backend="torch", device=device),
                    summarize_latencies(bins, backend="numpy"))
    hist = _hist_rows(bins, LATENCY_BINS, "torch", torch.device(device))
    if not np.array_equal(hist, np.stack(
            [np.bincount(b, minlength=LATENCY_BINS) for b in bins])):
        raise AssertionError("taskbench: B3 latency histogram differs from "
                             "np.bincount")

    card = _card_line()
    for r in reports:
        print(f"  taskbench {r.task:>14} {r.dataset:>12} {r.max_range:>5}: "
              f"speedup {r.speedup:.1f}x, fidelity {r.trend_fidelity:.4f} "
              f"({card})")
    return launches, {
        "card": card, "datasets": list(SWEEP_DATASETS),
        "max_ranges": list(TASKBENCH_RANGES), "scale": scale,
        "prepare_s": prepare_s, "run_s": run_s,
        "reports": [dict(r.to_dict()) for r in reports],
        "numpy_check_task": task.name,
        "trend_corr_max_abs_err_vs_numpy": corr_err,
        "below_floor_in_numpy_too": below,
        "latency_bins_checked": int(sum(len(b) for b in bins)),
        "launches": launches}


# ------------------------------------------------ phase 11: the public API
#: launches of the API phase: B1 once each for ``ops.stream_sample``,
#: ``nsa_batched`` and ``nsa_sweep``; B2 once each for ``ops.compact_mask``,
#: ``nsa_batched`` (all three streams in one call, where the reference
#: compacts each stream on its own) and ``nsa_sweep`` (all 18 rows in one
#: call); B3 once for ``ops.bucket_hist``. ``stream_sample_ref`` and
#: ``volatility_stats`` are plain PyTorch and launch nothing.
API_LAUNCHES = {"stream_sample": 3, "compact": 3, "metrics_fused": 1}


def run_api_path(device: str, scale: float, seed: int):
    """Phase 11: the 1-D ``ops`` wrappers on the userbehavior day at
    max_range 3600 (``stream_sample``, ``compact_mask``, ``bucket_hist``,
    ``volatility_stats``) held to ``stream_sample_ref``, ``compact_plain``,
    ``np.bincount`` and the float64 moments, then ``nsa_batched`` over the
    three datasets at 3600 and ``nsa_sweep`` over the paper's 3 x 6 grid
    held bit for bit to ``nsa(..., backend="numpy")``. Launches exactly
    :data:`API_LAUNCHES`; returns ``(launches, summary)``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.compact import compact_plain
    from repro_torch.streamsim import nsa, nsa_batched, nsa_sweep
    from repro_torch.streamsim.nsa import _multiple

    streams = _streams(scale, seed)[0]
    ub = streams[MAIN_DATASET]
    mult = _multiple(len(ub), ub.time_range, MAIN_RANGE, "time")
    wall = {}

    def timed(name, fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t0
        return out

    _zero_launches()
    ss, keep = timed("stream_sample", lambda: ops.stream_sample(
        ub.t, MAIN_RANGE, mult, device=device))
    idx, total = timed("compact_mask", lambda: ops.compact_mask(keep))
    kept = ss[idx[:total].long()].cpu().numpy()
    hist = timed("bucket_hist", lambda: ops.bucket_hist(
        kept, MAIN_RANGE, device=device))
    q = hist.cpu().numpy()
    vol = timed("volatility_stats", lambda: ops.volatility_stats(
        q, device=device))
    batched = timed("nsa_batched", lambda: nsa_batched(
        streams, MAIN_RANGE, backend="torch", device=device))
    swept = timed("nsa_sweep", lambda: nsa_sweep(
        {d: streams[d] for d in SWEEP_DATASETS}, SWEEP_RANGES,
        backend="torch", device=device))
    launches = _read_launches()
    expected = dict.fromkeys(launches, 0)
    expected.update(API_LAUNCHES)
    _check_launches("the API phase", launches, expected, exact=True)

    ref_ss, ref_keep = ops.stream_sample_ref(ub.t, MAIN_RANGE, mult,
                                             device=device)
    _exact("api stream_sample ss", ss, ref_ss)
    _exact("api stream_sample keep", keep, ref_keep)
    ref_idx, ref_tot = compact_plain(keep[None, :])
    _exact("api compact_mask", idx, ref_idx[0])
    if total != int(ref_tot[0]):
        raise AssertionError(f"api compact_mask: total {total} vs "
                             f"{int(ref_tot[0])}")
    if not np.array_equal(q, np.bincount(kept, minlength=MAIN_RANGE)):
        raise AssertionError("api bucket_hist differs from np.bincount")
    q64 = q.astype(np.float64)
    want = (q64.mean(), q64.var(), q64.std())
    got = tuple(float(x) for x in vol)
    for name, g, w in zip(("average", "variance", "std"), got, want):
        _stat_close(f"api volatility_stats {name}", g, w, MOMENT_RTOL)
    sim = nsa(ub, MAIN_RANGE, backend="numpy")
    if total != len(sim.t) or not np.array_equal(kept, sim.scale_stamp):
        raise AssertionError("api kept stamps differ from numpy NSA")
    for d in streams:
        _same_stream(f"api nsa_batched {d}", batched[d],
                     nsa(streams[d], MAIN_RANGE, backend="numpy"))
    for d in SWEEP_DATASETS:
        for mr in SWEEP_RANGES:
            _same_stream(f"api nsa_sweep {d}/{mr}", swept[(d, mr)],
                         nsa(streams[d], mr, backend="numpy"))
    return launches, {
        "dataset": MAIN_DATASET, "max_range": MAIN_RANGE, "scale": scale,
        "records": len(ub), "kept": total,
        "volatility": dict(zip(("average", "variance", "std"), got)),
        "max_volatility_rel_diff": max(abs(g - w) / abs(w)
                                       for g, w in zip(got, want)),
        "nsa_batched_streams": len(batched), "nsa_sweep_scenarios":
        len(swept), "wall_s": wall, "launches": launches,
        "tolerances": {"integers": "bit-equal", "volatility_rel":
                       MOMENT_RTOL, "nsa": "byte-equal to numpy"}}


# --------------------------------------------- phase 12: the sweep service
#: the service phase's lease TTL, far above a full-scale batch's time (a
#: few seconds), so no lease expires and every scenario runs exactly once
SERVICE_LEASE_TTL_S = 120.0
SERVICE_DEADLINE_S = 300.0
SERVICE_WORKER_TIMEOUT_S = 480.0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def service_worker(rank: int, port: int, store_dir: str, out: str,
                   device: str, scale: float, seed: int) -> None:
    """One participant of phase 12 (run as ``chip_smoke.py
    --service-worker RANK PORT STORE OUT DEVICE SCALE SEED``): joins a
    two-rank ``gloo`` group (which supplies only the topology), drives
    ``Controller(store, device=DEVICE).run_many(..., service=True)`` with
    its launch counts zeroed just before and read just after, and writes
    its reports, merged fidelity, launches and batches to ``out``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import process_topology
    from repro_torch.kernels import _build
    from repro_torch.streamsim import Controller
    from repro_torch.streamsim import service as svc_mod

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        # the libraries the parent built are loaded, not rebuilt (CPU
        # tensors run the plain versions and load none)
        unbuilt = [n for n in _build.kernel_names()
                   if device != "cpu" and
                   not _build._path(_build.target(n)).exists()]
        batches, poison = [], []
        run_batch = svc_mod.SweepService.run_batch
        finalize = svc_mod.SweepService.finalize

        def spy_batch(self, leases, *a, **kw):
            batches.append(sorted(leases))
            return run_batch(self, leases, *a, **kw)

        def spy_finalize(self, *a, **kw):
            poison.extend(self.store.list_markers(self.ns_poison))
            return finalize(self, *a, **kw)

        svc_mod.SweepService.run_batch = spy_batch
        svc_mod.SweepService.finalize = spy_finalize
        ctl = Controller(store_dir, metrics_dir=f"{store_dir}/_metrics{rank}",
                         device=device)
        consumer = _SweepConsumer()
        _zero_launches()
        t0 = time.perf_counter()
        reps = ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, consumer,
                            scale=scale, seed=seed, backend="torch",
                            service=True, lease_ttl_s=SERVICE_LEASE_TTL_S,
                            service_poll_s=0.1,
                            service_deadline_s=SERVICE_DEADLINE_S)
        if device != "cpu":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _read_launches()
        mine = sorted(f"{m['dataset']}__{m['max_range']}"
                      for m in ctl.load_metrics())
        payload = {
            "rank": rank, "topology": list(process_topology()),
            "device": device, "wall_s": wall_s,
            "launches": launches, "batches": batches, "mine": mine,
            "poison_markers": poison, "unbuilt_before": unbuilt,
            "rebuilt": sorted(_build.build_logs),
            "consumer_records": consumer.records,
            "reports": [r.to_json() for r in reps],
            "fidelity": [f.to_json() for f in ctl.last_fidelity]}
    finally:
        dist.destroy_process_group()
    with open(out, "w") as f:
        json.dump(payload, f)


def _merged_fidelity(name, got, mono) -> float:
    """Merged matrices: full, provenance on every row, within 1e-9 of
    phase 5's numpy matrices (the same reduction over the same exact
    count rows) and STAT_TOL of its torch matrices; returns the largest
    difference from numpy."""
    for f in got:
        if not f.provenance or len(f.provenance) != len(f.labels) or \
                not all(f.provenance):
            raise AssertionError(f"{name} {f.max_range}: provenance "
                                 f"{f.provenance}")
    _same_fidelity(f"{name} vs torch", got, mono[1], len(SWEEP_RANGES))
    return _same_fidelity(f"{name} vs numpy", got, mono[2],
                          len(SWEEP_RANGES), tol=1e-9)


def run_service_path(device: str, scale: float, seed: int, workdir: Path,
                     mono):
    """Phase 12: two participant processes on the one card, in a fresh
    store, serve the paper's grid through ``run_many(service=True)``
    (:func:`service_worker`). Checks: 18 reports each, all ``"ok"``, no
    poison marker; the scenarios they computed disjoint and covering the
    grid; rows and stored sims equal to phase 5's, statistics within 1e-3;
    the merged matrices within 1e-9 of phase 5's numpy matrices and 1e-3
    of its torch matrices, provenance on every row; per participant B1 =
    B2 = its batches and B3 = twice them (the batch's sims and the
    originals' report statistics), nothing else; the kernels loaded, not
    rebuilt. Returns ``(summed launches, summary)``."""
    from repro_torch.streamsim import (FidelityReport, SimulationReport,
                                       StreamStore)

    mono_reps = mono[0]
    store_dir = workdir / "service"
    port = _free_port()
    procs, outs = [], [workdir / f"service{r}.json" for r in range(2)]
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--service-worker", str(rank), str(port), str(store_dir),
                 str(outs[rank]), device, repr(scale), str(seed)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=SERVICE_WORKER_TIMEOUT_S)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_s = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"service participant {rank} failed:\n"
                                 f"{log[-4000:]}")
    parts = [json.loads(o.read_text()) for o in outs]
    grid = [(d, mr) for d in SWEEP_DATASETS for mr in SWEEP_RANGES]
    names = {f"{d}__{mr}" for d, mr in grid}
    st = StreamStore(store_dir)
    st_ref = StreamStore(workdir / "sweep_numpy")
    for (d, mr) in grid:
        _same_sim(st, st_ref, f"{d}__sim{mr}")
    fid_err = trend_err = 0.0
    total = dict.fromkeys(parts[0]["launches"], 0)
    for part in parts:
        rank = part["rank"]
        if part["topology"][:2] != [rank, 2] or part["unbuilt_before"] or \
                part["rebuilt"] or part["poison_markers"]:
            raise AssertionError(f"service participant {rank}: topology "
                                 f"{part['topology']}, unbuilt "
                                 f"{part['unbuilt_before']}, rebuilt "
                                 f"{part['rebuilt']}, poison "
                                 f"{part['poison_markers']}")
        reps = [SimulationReport.from_json(r) for r in part["reports"]]
        if [(r.dataset, r.max_range) for r in reps] != grid:
            raise AssertionError(f"service participant {rank}: reports out "
                                 "of grid order")
        for rep, ref in zip(reps, mono_reps):
            if rep.status != "ok":
                raise AssertionError(f"service {rep.dataset}/"
                                     f"{rep.max_range}: {rep.status} "
                                     f"({rep.failure})")
            _same_report(rep, ref)
            trend_err = max(trend_err, abs(rep.trend_corr - ref.trend_corr))
        fid = [FidelityReport(**dict(f, trend_corr=[
            [np.nan if v is None else v for v in row]
            for row in f["trend_corr"]])) for f in part["fidelity"]]
        fid_err = max(fid_err, _merged_fidelity(f"service {rank}", fid,
                                                mono))
        n = len(part["batches"])
        if sorted(sum(part["batches"], [])) != part["mine"] or any(
                len(b) != 1 for b in part["batches"]):
            raise AssertionError(f"service participant {rank}: batches "
                                 f"{part['batches']} vs {part['mine']}")
        expected = dict.fromkeys(part["launches"], 0)
        expected.update(stream_sample=n, compact=n, metrics_fused=2 * n)
        _check_launches(f"service participant {rank}", part["launches"],
                        expected, exact=True)
        for k, v in part["launches"].items():
            total[k] += v
    mine = [set(p["mine"]) for p in parts]
    if mine[0] & mine[1] or mine[0] | mine[1] != names:
        raise AssertionError(f"service: computed sets {mine} are not a "
                             "partition of the grid")
    markers = store_dir / "_markers"
    if markers.exists() and [x for x in markers.iterdir()
                             if not x.name.startswith(".")]:
        raise AssertionError("service: markers left behind")
    return total, {
        "participants": [{
            "rank": p["rank"], "wall_s": p["wall_s"],
            "scenarios": p["mine"], "batches": len(p["batches"]),
            "launches": {k: v for k, v in p["launches"].items() if v}}
            for p in parts],
        "wall_s": wall_s, "card": _card_line(),
        "lease_ttl_s": SERVICE_LEASE_TTL_S, "scenarios": len(grid),
        "max_fidelity_abs_diff_vs_numpy": fid_err,
        "max_trend_corr_abs_diff_vs_torch": trend_err,
        "tolerances": {"fidelity_vs_numpy": 1e-9, "stats": STAT_TOL,
                       "sims": "byte-equal"}}


# --------------------------------------- phase 13: static multi-host plans
MULTIHOST_RUNS = 6


def run_multihost_path(device: str, scale: float, seed: int, workdir: Path,
                       mono):
    """Phase 13: the static plan with ``n_hosts=2`` in a fresh shared
    store, host 0 and host 1 run alternately in this process until the
    grid is covered (each run plans what is still missing and takes its
    strided half). Each run launches B1 and B2 once when it computed a
    slice, B3 for that slice and once for the originals and cache hits,
    and B4 and B5 once for each local matrix (a max_range among its
    reports); the last run's merged matrices hold every label, with
    provenance from host0 and host1, within 1e-9 of phase 5's numpy
    matrices. Returns ``(summed launches, summary)``."""
    from repro_torch.streamsim import Controller

    mono_reps = mono[0]
    shared = workdir / "multihost"
    grid = [(d, mr) for d in SWEEP_DATASETS for mr in SWEEP_RANGES]
    done, runs, total = {}, [], None
    ctl = None
    for i in range(MULTIHOST_RUNS):
        host = i % 2
        ctl = Controller(str(shared), metrics_dir=str(workdir / f"mh{i}"),
                         device=device)
        _zero_launches()
        t0 = time.perf_counter()
        reps = ctl.run_many(SWEEP_DATASETS, SWEEP_RANGES, _SweepConsumer(),
                            scale=scale, seed=seed, backend="torch",
                            n_devices=1, host_index=host, n_hosts=2)
        run_s = time.perf_counter() - t0
        launches = _read_launches()
        plan = ctl.last_result.plan
        computed = len(plan.local_missing)
        local_mrs = {r.max_range for r in reps}
        expected = dict.fromkeys(launches, 0)
        expected.update(stream_sample=int(computed > 0),
                        compact=int(computed > 0),
                        metrics_fused=int(computed > 0) + 1,
                        trend_scan=len(local_mrs), pair_stats=len(local_mrs))
        _check_launches(f"multihost run {i} (host {host})", launches,
                        expected, exact=True)
        total = launches if total is None else {
            k: total[k] + v for k, v in launches.items()}
        for r in reps:
            done[(r.dataset, r.max_range)] = r
        runs.append({"host": host, "run_s": run_s, "computed": computed,
                     "reports": len(reps),
                     "merged": all(f.provenance for f in
                                   ctl.last_fidelity) and
                     len(ctl.last_fidelity) == len(SWEEP_RANGES),
                     "launches": {k: v for k, v in launches.items() if v}})
        if len(done) == len(grid):
            break
    if len(done) != len(grid):
        raise AssertionError(f"multihost: {len(done)} of {len(grid)} "
                             f"scenarios after {MULTIHOST_RUNS} runs")
    for sc, ref in zip(grid, mono_reps):
        _same_report(done[sc], ref)
    fid_err = _merged_fidelity("multihost", ctl.last_fidelity, mono)
    who = {w for f in ctl.last_fidelity for w in f.provenance}
    if not {"host0", "host1"} <= who:
        raise AssertionError(f"multihost: provenance {who}")
    return total, {"runs": runs, "scenarios": len(grid),
                   "provenance": sorted(who), "card": _card_line(),
                   "max_fidelity_abs_diff_vs_numpy": fid_err,
                   "tolerances": {"fidelity_vs_numpy": 1e-9,
                                  "stats": STAT_TOL}}


# --------------------------------------------------- phase 14: tile tuning
def run_tuning_path(device: str, scale: float, seed: int, workdir: Path,
                    run_launches):
    """Phase 14: ``Controller.run`` of phase 4 in a fresh store with
    ``autotune="force"`` (every key it dispatches swept over its
    instances, each candidate held to its plain version; none may be
    dropped), then, its simulated stream deleted so that NSA runs again,
    with ``autotune="cached"`` in the same store: no sweep (no timer call),
    launch counts equal phase 4's (``run_launches``), the cache file
    listing every key the run dispatched, and both runs' simulated streams
    byte-equal to phase 4's numpy run. Returns the launches of the cached
    run and the tuning record: each swept key's candidates with their
    times at the spec shape (the tuner's own timer: min of its reps, host
    clock around the call and a synchronise) and its winner."""
    from repro_torch.kernels import tuning
    from repro_torch.streamsim import Controller, StreamStore

    seen = {"keys": set(), "timer": 0}
    real_config_for = tuning.KernelTuner.config_for
    real_time_once = tuning.KernelTuner._time_once

    def config_for(self, kernel, **kw):
        if self.mode != "off":
            seen["keys"].add(tuning.TuneKey.from_shape(
                kernel, s=kw["s"], n=kw["n"], r=kw.get("r", 0),
                dtype=kw.get("dtype", "int32")).encode())
        return real_config_for(self, kernel, **kw)

    def time_once(self, fn, dev):
        seen["timer"] += 1
        return real_time_once(self, fn, dev)

    def consumer(queue):
        return {"records_seen": sum(len(b) for b in queue)}

    store_dir = workdir / "tuned"
    key = f"{MAIN_DATASET}__sim{MAIN_RANGE}"
    ctl = Controller(str(store_dir), device=device)
    tuning.KernelTuner.config_for = config_for
    tuning.KernelTuner._time_once = time_once
    try:
        t0 = time.perf_counter()
        forced = ctl.run(MAIN_DATASET, MAIN_RANGE, consumer, scale=scale,
                         seed=seed, backend="torch", autotune="force")
        force_s = time.perf_counter() - t0
        force_timer, force_keys = seen["timer"], sorted(seen["keys"])
        _same_sim(StreamStore(store_dir), StreamStore(workdir / "numpy"),
                  key)
        StreamStore(store_dir).delete(key)
        seen["timer"], seen["keys"] = 0, set()
        _zero_launches()
        t0 = time.perf_counter()
        cached = ctl.run(MAIN_DATASET, MAIN_RANGE, consumer, scale=scale,
                         seed=seed, backend="torch", autotune="cached")
        cached_s = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        tuning.KernelTuner.config_for = real_config_for
        tuning.KernelTuner._time_once = real_time_once
    _same_sim(StreamStore(store_dir), StreamStore(workdir / "numpy"), key)
    if force_timer == 0 or not force_keys:
        raise AssertionError("the force run swept nothing")
    if seen["timer"]:
        raise AssertionError(f"the cached run timed {seen['timer']} "
                             "candidates; every key should hit the cache")
    if launches != run_launches:
        raise AssertionError(f"cached run launches {launches}, phase 4 "
                             f"{run_launches}")
    if forced.simulated_rows != cached.simulated_rows or \
            cached.consumer_metrics["records_seen"] != cached.simulated_rows:
        raise AssertionError("the tuned runs' rows differ")
    kind = tuning.device_kind(device)
    entries = ctl.store.get_marker(tuning.TUNE_NAMESPACE, kind)["entries"]
    missing = (set(force_keys) | seen["keys"]) - set(entries)
    if missing:
        raise AssertionError(f"keys dispatched but not cached: {missing}")
    sweeps, dropped = {}, []
    for tuner in tuning._SHARED.values():
        if tuner.mode != "force" or tuner.store is None or \
                Path(tuner.store.root) != Path(ctl.store.root):
            continue
        dropped += tuner.dropped()
        for (_, k), rec in tuner.records.items():
            sweeps[k.encode()] = rec
    if dropped:
        raise AssertionError(f"force sweep dropped candidates: {dropped}")
    if set(sweeps) != set(force_keys):
        raise AssertionError(f"swept {sorted(sweeps)}, dispatched "
                             f"{force_keys}")
    return launches, {
        "kind": kind, "force_s": force_s, "cached_s": cached_s,
        "force_timer_calls": force_timer, "cached_timer_calls": 0,
        "simulated_rows": cached.simulated_rows, "cache": entries,
        "sweeps": sweeps}


# ------------------------------------------ phases 15-16: training on the card
#: the launcher's run: the paper's consumer LM at full size on the
#: userbehavior stream, one crash injected after the checkpoint of step 40
TRAIN_ARGV = ("--dataset", "userbehavior", "--max-range", "600", "--scale",
              "0.02", "--batch", "8", "--seq", "256", "--steps", "60",
              "--ckpt-every", "20", "--inject-failure", "45")
#: steps of the launcher's run replayed on the CPU, and their tolerance
TRAIN_CPU_STEPS, TRAIN_CPU_RTOL = 3, 1e-4
#: llama3-8b's widths, depth cut to 4 layers by the card's 80 GB (32
#: layers of bf16 weights and grads and f32 moments take ~128 GB); batch 1
#: of the train_4k shape's sequence
TRAIN_LLAMA_LAYERS, TRAIN_LLAMA_BATCH, TRAIN_LLAMA_STEPS = 4, 1, 3
TRAIN_REMAT_RTOL = 1e-2


def _args(argv) -> dict:
    """``--flag value`` pairs of an argument list, by flag name."""
    return {k.lstrip("-").replace("-", "_"): v
            for k, v in zip(argv[::2], argv[1::2])}


def run_train_path(device: str, seed: int, workdir: Path,
                   argv=TRAIN_ARGV, cpu_steps: int = TRAIN_CPU_STEPS):
    """Phase 15: ``repro_torch.launch.train.main`` on the paper's consumer
    LM at full size (12 layers, d 768, 12/4 heads, vocab 32,768, f32, no
    remat) fed by the userbehavior stream (POSD -> numpy NSA -> PSDA
    producer -> StreamBatcher -> TrainLoop), with a crash injected at step
    45, the launch counts zeroed just before and read just after (no
    kernel runs on this path). It must restart once from the step-40
    checkpoint, end at step 60 with a finite loss, descend (the mean loss
    of its last 10 steps below that of its first 10) and consume the
    stream. Then the launcher's first ``cpu_steps`` steps are run again
    on the CPU from the same parameters (drawn on the card from the seed
    and copied) and the same batches (the stream rebuilt): each loss
    within 1e-4 relative of the card's, with TF32 off."""
    import types

    import torch

    from repro_torch import tree
    from repro_torch.configs import get_smoke
    from repro_torch.configs.paper_stream import consumer_lm
    from repro_torch.launch import train
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import AdamW, adamw_init
    from repro_torch.training.steps import jit_train_step

    flags = _args(argv)
    steps = int(flags["steps"])
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    out = train.main(["--device", device, "--seed", str(seed),
                      "--ckpt-dir", str(workdir / "train_ckpt"),
                      "--out", str(workdir / "train_metrics.json"), *argv])
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    summary, history = out["summary"], out["history"]
    if summary["restarts"] != 1 or summary["final_step"] != steps or \
            not np.isfinite(summary["final_loss"]):
        raise AssertionError(f"train: {summary}")
    losses = [h["loss"] for h in history]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not last < first:
        raise AssertionError(f"train: no descent, mean loss {first} over "
                             f"the first 10 steps, {last} over the last 10")
    stream = summary["stream"]
    if stream["buckets_consumed"] < 1 or stream["records_consumed"] < 1:
        raise AssertionError(f"train: stream counters {stream}")
    if any(launches.values()):
        raise AssertionError(f"train launched kernels: {launches}")

    # the first steps again on the CPU, from the same weights and batches
    # (the launcher's model: its remat rule keeps none at 12 layers)
    cfg = get_smoke(flags["arch"]) if "arch" in flags else consumer_lm()
    cfg = cfg.replace(remat="none") if cfg.n_layers <= 12 else cfg
    params = tree.tree_map(lambda t: t.cpu(), transformer.init_params(
        cfg, seed, device=device))
    batches, _ = train.build_batches(types.SimpleNamespace(
        dataset=flags["dataset"], scale=float(flags["scale"]), seed=seed,
        max_range=int(flags["max_range"]), batch=int(flags["batch"]),
        seq=int(flags["seq"])), cfg.vocab_size)
    step = jit_train_step(cfg, AdamW(lr=float(flags.get("lr", 3e-4)),
                                     total_steps=steps), donate=False)
    opt_state = adamw_init(params)
    cpu_losses = []
    t0 = time.perf_counter()
    for _ in range(cpu_steps):
        params, opt_state, m = step(params, opt_state, next(batches))
        cpu_losses.append(float(m["loss"]))
    cpu_s = time.perf_counter() - t0
    card_losses = losses[:cpu_steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)]
    if max(rel) > TRAIN_CPU_RTOL:
        raise AssertionError(f"train: card losses {card_losses} vs CPU "
                             f"{cpu_losses} beyond {TRAIN_CPU_RTOL}")
    tokens = int(flags["batch"]) * int(flags["seq"])
    step_ms = float(np.median([h["wall_s"] for h in history[1:]])) * 1e3
    n_params = sum(t.numel() for t in tree.leaves(params))
    report = {
        "card": _card_line(), "arch": cfg.name, "params": n_params,
        "layers": cfg.n_layers, "d_model": cfg.d_model, "dtype": cfg.dtype,
        "remat": cfg.remat, "argv": list(argv), "summary": summary,
        "wall_s": wall, "steps_run": len(history),
        "first10_mean_loss": first, "last10_mean_loss": last,
        "train_step_ms": step_ms, "train_tokens_per_s": tokens * 1e3 / step_ms,
        "peak_mem_gb": peak_gb, "tf32": bool(
            torch.backends.cuda.matmul.allow_tf32),
        "cpu_steps": cpu_steps, "cpu_s": cpu_s, "card_losses": card_losses,
        "cpu_losses": cpu_losses, "cpu_max_rel_err": max(rel)}
    print(f"train: {cfg.name} {n_params / 1e6:.1f} M, step {step_ms:.2f} ms "
          f"({report['train_tokens_per_s']:.0f} tokens/s), peak "
          f"{peak_gb:.2f} GB; first {cpu_steps} losses within "
          f"{max(rel):.2e} of the CPU's with TF32 off [{report['card']}]")
    return launches, report


def _timed_saves(mgr):
    """``mgr`` (a ``CheckpointManager``) with each save's seconds (host
    copy and write, for a blocking save) appended to ``mgr.save_s``."""
    mgr.save_s, save = [], mgr.save

    def timed(*a, **kw):
        t0 = time.perf_counter()
        save(*a, **kw)
        mgr.save_s.append(time.perf_counter() - t0)
    mgr.save = timed
    return mgr


def _bit_equal(a, b) -> bool:
    import torch

    def bits(t):
        t = t.reshape(-1)
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(bits(a), bits(b))


def run_train_llama3_path(device: str, seed: int, workdir: Path, cfg=None,
                          seq: int = None):
    """Phase 16: llama3-8b at full width (d 4096, 32/8 heads, head_dim 128,
    d_ff 14,336, vocab 128,256, bf16), depth cut to 4 layers, loss_chunk
    512, on one sequence of the train_4k shape (S 4096, batch cut to 1)
    from ``SyntheticBatcher``. First the step-0 loss and gradient norm
    with ``remat="none"`` and ``"full"`` (equal within 1e-2 relative; the
    peak device memory of each), the loss within 0.5 of ln V + 1/2 (the
    random init gives each position unit-variance logits: the final norm
    makes the hidden state's mean square 1 and the head is N(0, 1/d), and
    E[logsumexp] of V such logits is ln V + 1/2). Then 3 steps of
    ``jit_train_step`` (donated: in place) under a ``TrainLoop`` that
    checkpoints the bf16 state once, at its end, with the launch counts
    zeroed just before and read just after; the checkpoint restored and
    compared bit for bit with the state. Prints step time, tokens/s, the
    peaks and the checkpoint's save and restore seconds. ``cfg`` and
    ``seq`` replace the shape (a small one rehearses the phase on the
    CPU)."""
    import gc
    import itertools
    import math
    import shutil

    import torch

    from repro_torch import tree
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import transformer
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.data import SyntheticBatcher
    from repro_torch.training.optimizer import AdamW, adamw_init, global_norm
    from repro_torch.training.steps import jit_train_step, value_and_grad
    from repro_torch.training.train_loop import TrainLoop, TrainLoopConfig

    if cfg is None:
        cfg = get_config("llama3-8b").replace(
            n_layers=TRAIN_LLAMA_LAYERS, remat="full", loss_chunk=512)
    seq = SHAPES["train_4k"].seq_len if seq is None else seq
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    batches = iter(SyntheticBatcher(TRAIN_LLAMA_BATCH, seq, cfg.vocab_size,
                                    seed=seed))
    first = next(batches)

    remat = {}
    for mode in ("none", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (loss, _), grads = value_and_grad(cfg.replace(remat=mode), params,
                                          first)
        gnorm = float(global_norm(grads))
        remat[mode] = {"loss": float(loss), "grad_norm": gnorm,
                       "s": time.perf_counter() - t0,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del grads, loss
    for k in ("loss", "grad_norm"):
        a, b = remat["none"][k], remat["full"][k]
        if not abs(a - b) <= TRAIN_REMAT_RTOL * abs(a):
            raise AssertionError(f"train_llama3: step-0 {k} {a} with remat "
                                 f"none, {b} with full")
    expect = math.log(cfg.vocab_size) + 0.5
    if not abs(remat["full"]["loss"] - expect) < 0.5:
        raise AssertionError(f"train_llama3: step-0 loss "
                             f"{remat['full']['loss']}, random init "
                             f"expects about {expect}")

    ckdir = workdir / "train_llama3_ckpt"
    ckpt = _timed_saves(CheckpointManager(ckdir, keep=1))
    free_gb = shutil.disk_usage(workdir).free / 1e9
    loop = TrainLoop(
        jit_train_step(cfg, AdamW(total_steps=TRAIN_LLAMA_STEPS)), params,
        adamw_init(params), itertools.chain([first], batches), ckpt,
        TrainLoopConfig(total_steps=TRAIN_LLAMA_STEPS,
                        checkpoint_every=TRAIN_LLAMA_STEPS + 1,
                        async_checkpoint=False))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    summary = loop.run()
    run_s = time.perf_counter() - t0
    launches = _read_launches()
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in loop.history]
    if summary["final_step"] != TRAIN_LLAMA_STEPS or \
            not all(np.isfinite(losses)) or ckpt.steps() != [
                TRAIN_LLAMA_STEPS] or len(ckpt.save_s) != 1:
        raise AssertionError(f"train_llama3: {summary}, checkpoints "
                             f"{ckpt.steps()}")
    if not abs(losses[0] - remat["full"]["loss"]) <= \
            TRAIN_REMAT_RTOL * abs(losses[0]):
        raise AssertionError(f"train_llama3: loop step 0 loss {losses[0]}, "
                             f"value_and_grad {remat['full']['loss']}")
    if any(launches.values()):
        raise AssertionError(f"train_llama3 launched kernels: {launches}")
    ck_bytes = sum(f.stat().st_size for f in ckdir.rglob("*") if
                   f.is_file())
    t0 = time.perf_counter()
    restored = ckpt.restore(loop._state())
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    state = tree.leaves(loop._state())
    got = tree.leaves(restored)
    if len(got) != len(state) or not all(
            _bit_equal(a, b) for a, b in zip(got, state)):
        raise AssertionError("train_llama3: the restored checkpoint differs "
                             "from the state")
    if tree.leaves(loop.params)[0].dtype != torch.bfloat16:
        raise AssertionError("train_llama3: parameters are not bf16")
    tokens = TRAIN_LLAMA_BATCH * seq
    step_ms = float(np.median([h["wall_s"] for h in loop.history[1:]])) * 1e3
    report = {
        "card": _card_line(), "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim_,
        "d_ff": cfg.d_ff, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "remat": cfg.remat, "loss_chunk": cfg.loss_chunk,
        "batch": TRAIN_LLAMA_BATCH, "seq": seq, "params": n_params,
        "init_s": init_s, "step0": remat, "ln_vocab_plus_half": expect,
        "losses": losses, "step_walls_s": [h["wall_s"] for h in
                                           loop.history],
        "train_step_ms": step_ms, "train_tokens_per_s": tokens * 1e3 / step_ms,
        "run_s": run_s, "peak_mem_gb": train_peak,
        "ckpt_bytes": ck_bytes, "ckpt_save_s": ckpt.save_s[0],
        "ckpt_restore_s": restore_s, "disk_free_gb_before": free_gb}
    print(f"train_llama3: {n_params / 1e9:.3f} B params, step "
          f"{step_ms:.1f} ms ({report['train_tokens_per_s']:.0f} tokens/s), "
          f"peak {train_peak:.2f} GB [{report['card']}]")
    print(f"train_llama3: loss+grad peak {remat['none']['peak_gb']:.2f} GB "
          f"with remat none, {remat['full']['peak_gb']:.2f} GB with full "
          f"[{report['card']}]")
    print(f"train_llama3: checkpoint {ck_bytes / 1e9:.2f} GB saved in "
          f"{ckpt.save_s[0]:.2f} s, restored in {restore_s:.2f} s "
          f"[{report['card']}]")
    del loop, restored, state, got
    shutil.rmtree(ckdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, report


# --------------------------------------- phase 17: the other model families
#: the families served at their published widths, by depth (None: whole).
#: llama4-scout is cut from 48 layers to 4 and deepseek-v3 from 61 to 5 by
#: the card's 80 GB: whole, their bf16 weights are 215 GB and 1.34 TB; at
#: 4 and 5 layers 21.8 GB and 54.6 GB (deepseek's 5 keep its 3 dense
#: layers, two MoE layers in one run and the MTP head)
FAMILIES = {"recurrentgemma-2b": None, "rwkv6-1_6b": None,
            "llama4-scout-17b-a16e": 4, "deepseek-v3-671b": 5}
#: their parameter leaves, counted from the reference's ``init_params``
#: under ``jax.eval_shape`` (``ModelConfig.n_params()`` is not exact for
#: these families)
FAMILY_LEAVES = {"recurrentgemma-2b": 2_688_043_520,
                 "rwkv6-1_6b": 1_583_941_632,
                 "llama4-scout-17b-a16e": 10_877_383_680,
                 "deepseek-v3-671b": 27_304_638_464}
#: the ring-wrap check: one prompt longer than recurrentgemma's 2048-slot
#: ring, then decode steps; its prefill runs the chunked windowed path with
#: 512-position KV chunks (2560 is not a multiple of the default 1024)
RING_PROMPT, RING_MAX_LEN, RING_STEPS, RING_CHUNK_KV = 2560, 4096, 4, 512
#: the training check: whole depth, one sequence, three steps
FAMILY_TRAIN = ("recurrentgemma-2b", "rwkv6-1_6b")
FAMILY_TRAIN_SEQ, FAMILY_TRAIN_STEPS = 512, 3
#: the launchers, each on its smoke config
LAUNCH_ARCHS = ("recurrentgemma-2b", "rwkv6-1_6b", "llama4-scout-17b-a16e",
                "deepseek-v3-671b", "llama3-8b")


def _family_cfg(arch: str):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return cfg if FAMILIES[arch] is None else cfg.replace(
        n_layers=FAMILIES[arch])


def _serve_family(device: str, seed: int, workdir: Path, cfg, params,
                  reps: int):
    """The counted serve run of phase 9 (:func:`_serve_run`), then prefill
    and decode step times outside it. For a config whose decode runs B8,
    the inputs B8 is given in its first and last such layer of one decode
    step from the prefill's cache are captured and B8 is held to its plain
    version on them (:data:`DECODE_TOL`)."""
    import torch

    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models import transformer

    launches, rep, task, run_s, peak_gb = _serve_run(
        device, seed, workdir / f"serve_{cfg.name}", f"families/{cfg.name}",
        cfg, params)
    m = rep.consumer_metrics

    rng = np.random.default_rng(seed)
    slots, p_len = SERVE_TASK["slots"], SERVE_TASK["prompt_len"]
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (slots, p_len),
                                         dtype=np.int32)).to(device)
    lens = torch.from_numpy(rng.integers(1, p_len + 1, slots,
                                         dtype=np.int32)).to(device)

    def prefill():
        return transformer.prefill(cfg, params, toks, lens,
                                   SERVE_TASK["max_len"])
    with torch.no_grad():
        prefill_ms = _host_ms(prefill, reps)
        logits, cache = prefill()
        nxt = torch.argmax(logits, -1).to(torch.int32)
        decode_ms = _host_ms(lambda: transformer.decode_step(
            cfg, params, cache, nxt), reps)
        b8_err, b8_shapes = None, []
        if _b8_layers(cfg):
            _, seen = _capture_decode(cfg, params, cache, nxt,
                                      (0, _b8_layers(cfg) - 1))
            b8_err = 0.0
            for layer, (q, k, v, ln) in sorted(seen.items()):
                b8_shapes.append(f"B={q.shape[0]} S={k.shape[1]} "
                                 f"H={q.shape[1]} Kh={k.shape[2]} "
                                 f"D={q.shape[2]} {q.dtype}")
                b8_err = max(b8_err, _decode_err(
                    f"flash_decode/{cfg.name} layer {layer}",
                    flash_decode(q, k, v, ln),
                    flash_decode_plain(q, k, v, ln), cfg.dtype))
            del seen
    del task, cache, logits
    return launches, {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "b8_layers": _b8_layers(cfg), "run_s": run_s,
        "task_records": m["task_records"],
        "serving_finished": m["serving_finished"],
        "serving_tokens_out": m["serving_tokens_out"],
        "serving_decode_steps": m["serving_decode_steps"],
        "task_wall_s": m["task_wall_s"],
        "tokens_per_s": m["serving_tokens_out"] / m["task_wall_s"],
        "decode_step_ms": decode_ms, "prefill_ms": prefill_ms,
        "prefill_shape": f"B={slots} P={p_len} "
                         f"max_len={SERVE_TASK['max_len']}",
        "peak_mem_gb": peak_gb, "b8_captured_shapes": b8_shapes,
        "b8_max_abs_err": b8_err, "launches": launches}


def _ring_wrap(device: str, seed: int, cfg, params):
    """recurrentgemma-2b: one prompt of 2560 tokens with max_len 4096, so
    the 2048-slot rings wrap (the prefill rolls them), then 4 greedy
    decode steps. B8 is held to its plain version on the inputs captured
    from the first and last local layer of the first step (lengths = the
    ring) and the step's logits through B8 and through the plain version
    are set side by side; the prefill and decode logits are reported
    against the port's teacher-forced forward (naive attention) over the
    prompt and the generated tokens."""
    import torch

    from repro_torch.kernels.flash_decode import (flash_decode,
                                                  flash_decode_plain)
    from repro_torch.models import transformer
    from repro_torch.models.layers import unembed

    rcfg = cfg.replace(attn_chunk_kv=RING_CHUNK_KV)
    rng = np.random.default_rng(seed + 1)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, RING_PROMPT),
                                         dtype=np.int32)).to(device)
    lens = torch.full((1,), RING_PROMPT, dtype=torch.int32, device=device)
    with torch.no_grad():
        logits, cache = transformer.prefill(rcfg, params, toks, lens,
                                            RING_MAX_LEN)
        rings = {tuple(run["k"].shape[2:3]) for run in cache["runs"]
                 if "k" in run}
        if rings != {(cfg.window,)}:
            raise AssertionError(f"ring_wrap: local caches of {rings} "
                                 f"slots, the window is {cfg.window}")
        nxt = torch.argmax(logits, -1).to(torch.int32)
        last = _b8_layers(cfg) - 1
        lk, seen = _capture_decode(rcfg, params, cache, nxt, (0, last))
        lp, _ = _capture_decode(rcfg, params, cache, nxt, (),
                                flash_decode_plain)
        swap = float((lk - lp).abs().max())
        del lk, lp
        b8_err = 0.0
        for layer, (q, k, v, ln) in sorted(seen.items()):
            if ln.tolist() != [cfg.window]:
                raise AssertionError(f"ring_wrap: B8 lengths {ln.tolist()} "
                                     f"at a full ring of {cfg.window}")
            b8_err = max(b8_err, _decode_err(
                f"flash_decode/ring_wrap layer {layer}",
                flash_decode(q, k, v, ln), flash_decode_plain(q, k, v, ln),
                cfg.dtype))
        outs, gen = [logits], []
        for _ in range(RING_STEPS):
            gen.append(nxt)
            logits, cache = transformer.decode_step(rcfg, params, cache, nxt)
            outs.append(logits)
            nxt = torch.argmax(logits, -1).to(torch.int32)
        seq = torch.cat([toks, torch.stack(gen, 1)], 1)
        hidden, _ = transformer.forward(rcfg.replace(attn_impl="naive"),
                                        params, seq)
        want = unembed(hidden[0, RING_PROMPT - 1:],
                       transformer._head_table(cfg, params),
                       cfg.logit_softcap)
        got = torch.cat(outs, 0)
    torch.cuda.synchronize()
    diff = (got - want).abs().amax(-1)
    out = {"prompt": RING_PROMPT, "max_len": RING_MAX_LEN,
           "ring": cfg.window, "decode_steps": RING_STEPS,
           "kv_chunk": RING_CHUNK_KV, "b8_max_abs_err": b8_err,
           "plain_swap_max_abs_logit_diff": swap,
           "max_abs_logit_diff_vs_forward": [float(x) for x in diff],
           "top1_agreement_vs_forward": float(
               (got.argmax(-1) == want.argmax(-1)).float().mean())}
    print(f"families/ring_wrap: B8 within {b8_err:.2e} of plain (logits "
          f"{swap:.3e} apart); logits vs forward "
          f"{out['max_abs_logit_diff_vs_forward']}")
    return out


def _train_family(device: str, seed: int, cfg, params):
    """Three donated ``jit_train_step`` steps at full depth (B 1, S 512,
    remat full) after the step-0 loss under remat none and full; the
    parameters change, the losses are finite and the two step-0 losses
    agree within 1e-2."""
    import gc

    import torch

    from repro_torch import tree
    from repro_torch.training.data import SyntheticBatcher
    from repro_torch.training.optimizer import AdamW, adamw_init
    from repro_torch.training.steps import jit_train_step, value_and_grad

    cfg = cfg.replace(remat="full")
    batches = iter(SyntheticBatcher(1, FAMILY_TRAIN_SEQ, cfg.vocab_size,
                                    seed=seed))
    first = next(batches)
    step0 = {}
    for mode in ("none", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        (loss, _), grads = value_and_grad(cfg.replace(remat=mode), params,
                                          first)
        step0[mode] = {"loss": float(loss),
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del grads, loss
    a, b = step0["none"]["loss"], step0["full"]["loss"]
    name = f"families/train {cfg.name}"
    if not (np.isfinite(a) and abs(a - b) <= TRAIN_REMAT_RTOL * abs(a)):
        raise AssertionError(f"{name}: step-0 loss {a} with remat none, "
                             f"{b} with full")
    probes = [t[:1].clone() for t in tree.leaves(params)]
    step = jit_train_step(cfg, AdamW(total_steps=FAMILY_TRAIN_STEPS))
    opt_state = adamw_init(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, walls = [], []
    batch = first
    for _ in range(FAMILY_TRAIN_STEPS):
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        batch = next(batches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    changed = sum(not torch.equal(p, t[:1]) for p, t in zip(
        probes, tree.leaves(params)))
    if not all(np.isfinite(losses)) or not changed:
        raise AssertionError(f"{name}: losses {losses}, {changed} leaves "
                             "changed")
    if abs(losses[0] - b) > TRAIN_REMAT_RTOL * abs(b):
        raise AssertionError(f"{name}: step 0 loss {losses[0]}, "
                             f"value_and_grad {b}")
    step_ms = float(np.median(walls[1:])) * 1e3
    out = {"seq": FAMILY_TRAIN_SEQ, "batch": 1, "remat": "full",
           "step0": step0, "losses": losses, "step_walls_s": walls,
           "train_step_ms": step_ms, "peak_mem_gb": peak_gb,
           "leaves_changed": changed, "leaves": len(probes)}
    print(f"{name}: step {step_ms:.1f} ms, peak {peak_gb:.2f} GB, losses "
          f"{losses} [{_card_line()}]")
    del opt_state, m
    return out


def _run_launchers(device: str, workdir: Path):
    """``launch.serve --arch`` and ``launch.train --arch`` on each smoke
    config of :data:`LAUNCH_ARCHS`: every arrival served, B8 once per
    decode step and attention layer, three train steps with a finite
    loss."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import serve, train

    out = {}
    for arch in LAUNCH_ARCHS:
        cfg = get_smoke(arch)
        _zero_launches()
        t0 = time.perf_counter()
        summary = serve.main(["--device", device, "--arch", arch, "--out",
                              str(workdir / f"serve_{arch}.json")])
        serve_s = time.perf_counter() - t0
        launches = _read_launches()
        if summary["finished"] != summary["arrivals"] or \
                summary["arrivals"] < 1:
            raise AssertionError(f"launch.serve --arch {arch}: {summary}")
        _check_launches(f"launch.serve --arch {arch}", launches, {
            "flash_decode": summary["decode_steps"] * _b8_layers(cfg)},
            exact=True)
        t0 = time.perf_counter()
        trained = train.main(["--device", device, "--arch", arch,
                              "--dataset", "synthetic", "--steps", "3",
                              "--batch", "2", "--seq", "32",
                              "--ckpt-dir", str(workdir / f"ckpt_{arch}"),
                              "--out", str(workdir / f"train_{arch}.json")])
        train_s = time.perf_counter() - t0
        if trained["summary"]["final_step"] != 3 or \
                not np.isfinite(trained["summary"]["final_loss"]):
            raise AssertionError(f"launch.train --arch {arch}: "
                                 f"{trained['summary']}")
        out[arch] = {"serve": summary, "serve_s": serve_s,
                     "flash_decode": launches["flash_decode"],
                     "train_final_loss": trained["summary"]["final_loss"],
                     "train_s": train_s}
    return out


def run_families_path(device: str, seed: int, workdir: Path,
                      reps: int = 5):
    """Phase 17: the four other families at their published widths
    (:data:`FAMILIES`), each with seeded random weights on the card and
    its leaf count held to :data:`FAMILY_LEAVES`, served under
    ``Controller.run`` as in phase 9 (B8 exactly decode steps x its
    attention layers: 8 for recurrentgemma, 4 for llama4-scout, none for
    rwkv6 and deepseek, and B8 held to its plain version on the inputs
    captured from a decode step); recurrentgemma's ring wrap and the
    training of recurrentgemma and rwkv6 at full depth; then the
    launchers on the smoke configs. Returns the launches of the four serve
    runs, summed, and the report."""
    import gc

    import torch

    from repro_torch import tree
    from repro_torch.models import transformer

    report, total = {}, {}
    for arch in FAMILIES:
        cfg = _family_cfg(arch)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = transformer.init_params(cfg, seed, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = sum(t.numel() for t in tree.leaves(params))
        if leaves != FAMILY_LEAVES[arch]:
            raise AssertionError(f"families/{arch}: {leaves} parameters, "
                                 f"the reference has {FAMILY_LEAVES[arch]}")
        launches, rep = _serve_family(device, seed, workdir, cfg, params,
                                      reps)
        rep.update(params=leaves, init_s=init_s, card=_card_line())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        print(f"families/{arch}: {cfg.n_layers} layers, {leaves / 1e9:.3f} "
              f"B params (init {init_s:.1f} s), decode step "
              f"{rep['decode_step_ms']:.2f} ms, prefill "
              f"{rep['prefill_ms']:.2f} ms, {rep['tokens_per_s']:.1f} "
              f"tokens/s, peak {rep['peak_mem_gb']:.2f} GB"
              + ("" if rep["b8_max_abs_err"] is None else
                 f", B8 within {rep['b8_max_abs_err']:.2e} of plain on "
                 "captured inputs") + f" [{rep['card']}]")
        if arch == "recurrentgemma-2b":
            rep["ring_wrap"] = _ring_wrap(device, seed, cfg, params)
        if arch in FAMILY_TRAIN:
            rep["train"] = _train_family(device, seed, cfg, params)
        report[arch] = rep
        del params
    gc.collect()
    torch.cuda.empty_cache()
    report["launchers"] = _run_launchers(device, workdir)
    return total, report


def _host_ms(fn, reps: int) -> float:
    """Median wall time of ``fn()`` ending in a device synchronise, after
    one warm-up (a step or request time, not a kernel time)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build, tuning

    # f32 products in full f32 everywhere (the consumer LM and the
    # yardsticks), whatever the installation's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    instances = [t for t in tuning.lattice_builds() if t[1]]
    _build.build_all(instances=instances)
    build_s = time.perf_counter() - t0
    print(f"build: {len(_build.kernel_names())} sources (kernels B1-B8) and "
          f"{len(instances)} tile instances, one nvcc each, in "
          f"{build_s:.1f} s")
    for name, secs in sorted(_build.build_seconds.items()):
        print(f"  {name}: {secs:.1f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    cases = {}
    rows = check_kernels("cuda", MAIN_SCALE, MAIN_SEED, keep_cases=cases)
    edges = check_sample_compact_edges("cuda", MAIN_SCALE, MAIN_SEED)
    print(json.dumps({"b1_b2_edges": edges}), flush=True)
    rows.update(check_trend_kernels("cuda", MAIN_SCALE, MAIN_SEED))
    rows.update(check_carry_kernels("cuda", MAIN_SEED, cases))
    tiles = check_instances("cuda", MAIN_SCALE, MAIN_SEED, cases)
    cases.clear()
    rows.update(check_decode_kernel("cuda", MAIN_SEED))
    check_s = time.perf_counter() - t0
    print(f"kernel checks passed in {check_s:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run_launches, report = run_main_path("cuda", MAIN_SCALE, MAIN_SEED,
                                             Path(tmp))
        report.update(build_s=build_s, kernel_check_s=check_s)
        print(json.dumps({"report": report}), flush=True)
        sweep_launches, sweep, mono = run_sweep_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp))
        print(json.dumps({"sweep": sweep}), flush=True)
        chunked_launches, chunked = run_chunked_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp), mono)
        print(json.dumps({"chunked": chunked}), flush=True)
        md_launches, multiday, chunk_in = run_multiday_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp))
        print(json.dumps({"multiday": multiday}), flush=True)
        for name, row in check_chunk_shape(chunk_in).items():
            rows[name]["chunk"] = row
        for name, row in time_instances_chunk(chunk_in).items():
            for label, ms in row.items():
                tiles["times"][name][label]["chunk"] = ms
        del chunk_in
        serve_launches, serve = run_serve_path(Path(tmp))
        print(json.dumps({"serve": serve}), flush=True)
        llama_launches, llama = run_serve_llama3_path("cuda", MAIN_SEED,
                                                      Path(tmp))
        print(json.dumps({"serve_llama3": llama}), flush=True)
        tb_launches, taskbench = run_taskbench_path("cuda", MAIN_SCALE,
                                                    MAIN_SEED)
        print(json.dumps({"taskbench": taskbench}), flush=True)
        api_launches, api = run_api_path("cuda", MAIN_SCALE, MAIN_SEED)
        print(json.dumps({"api": api}), flush=True)
        svc_launches, service = run_service_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp), mono)
        print(json.dumps({"service": service}), flush=True)
        mh_launches, multihost = run_multihost_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp), mono)
        print(json.dumps({"multihost": multihost}), flush=True)
        tune_launches, tuned = run_tuning_path(
            "cuda", MAIN_SCALE, MAIN_SEED, Path(tmp), run_launches)
        print(json.dumps({"tuning": dict(
            card=_card_line(), build_s=build_s,
            instance_build_s=dict(sorted(_build.build_seconds.items())),
            **tiles, run=tuned)}), flush=True)
        train_launches, trained = run_train_path("cuda", MAIN_SEED,
                                                 Path(tmp))
        print(json.dumps({"train": trained}), flush=True)
        tl_launches, trained_llama = run_train_llama3_path(
            "cuda", MAIN_SEED, Path(tmp))
        print(json.dumps({"train_llama3": trained_llama}), flush=True)
        t0 = time.perf_counter()
        fam_launches, families = run_families_path("cuda", MAIN_SEED,
                                                   Path(tmp))
        families["phase_s"] = time.perf_counter() - t0
        print(json.dumps({"families": families}), flush=True)

    by_path = {"run": run_launches, "run_many": sweep_launches,
               "run_many_chunked": chunked_launches, "multiday": md_launches,
               "serve": serve_launches, "serve_llama3": llama_launches,
               "taskbench": tb_launches, "api": api_launches,
               "service": svc_launches, "multihost": mh_launches,
               "tuning": tune_launches, "train": train_launches,
               "train_llama3": tl_launches, "families": fam_launches}
    replaces = {
        "stream_sample": ("src/repro_torch/csrc/stream_sample.cu",
                          "src/repro/kernels/stream_sample.py:146",
                          "run_many"),
        "compact": ("src/repro_torch/csrc/compact.cu",
                    "src/repro/kernels/compact.py:139", "run_many"),
        "metrics_fused": ("src/repro_torch/csrc/metrics_fused.cu",
                          "src/repro/kernels/metrics_fused.py:269",
                          "run_many"),
        "trend_scan": ("src/repro_torch/csrc/trend_scan.cu",
                       "src/repro/kernels/trend_scan.py:107", "run_many"),
        "pair_stats": ("src/repro_torch/csrc/pair_stats.cu",
                       "src/repro/kernels/trend_scan.py:221", "run_many"),
        "stream_metrics_carry": ("src/repro_torch/csrc/metrics_fused.cu",
                                 "src/repro/kernels/metrics_fused.py:224",
                                 "run_many_chunked"),
        "trend_scan_carry": ("src/repro_torch/csrc/trend_scan.cu",
                             "src/repro/kernels/trend_scan.py:167",
                             "multiday"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:93",
                         "serve_llama3"),
    }
    extra = ("sim", "sweep", "chunk", "week", "S37", "S2_K1024", "S2_K4096",
             "max_scaled_err", "records", "multiday", "fidelity", "serve",
             "max_abs_err_f32", "max_abs_err_bf16", "library_max_abs_err",
             "library_nonzero_ms", "kernels_per_call", "host_ms",
             "recurrentgemma", "kernels_per_call_shapes",
             "planted_faults_rejected")
    kernels = []
    for name, (source, tpu, path) in replaces.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": by_path[path][name],
            "launches_by_path": {p: ls[name] for p, ls in by_path.items()},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], **{k: r[k] for k in extra if k in r}})
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{name} never launched on its path")
    print(f"card: {_card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--service-worker"]:
        rank, port, store, out, dev, scale, seed = sys.argv[2:9]
        service_worker(int(rank), int(port), store, out, dev, float(scale),
                       int(seed))
        sys.exit(0)
    sys.exit(main())
