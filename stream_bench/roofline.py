"""The yardstick of the kernels: peaks, and the bytes and operations each
kernel of a job needs, from the job's shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores. A
launch's bound is the larger of its bytes over the first and its
operations over the second. Each byte the work needs is counted read once
or written once, however often a kernel touches it: only the records
below a row's length, each row's own range of buckets, the kept records'
positions. The shapes come from the job (records in each original, the
scenarios, the records each keeps, the buckets), never from the program's
kernels, their wrappers or their padding, so the yardstick stays put
whatever implements a kernel.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

Launch = Tuple[str, float, float]     # (kernel, bytes, operations)


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S)


def stream_sample(n_records: Sequence[int], max_ranges: Sequence[int]
                  ) -> Launch:
    """B1, NSA's sample over rows of ``n_records``: per record a 4-byte
    stamp read, a 4-byte scale stamp and a keep byte written, ~30
    operations; per row its 12-byte scalars, its length, and of its three
    4-byte tables the buckets its records reach (one either side of the
    f32 guess), at most the widest row's range."""
    S, n = len(n_records), sum(n_records)
    W = max(max_ranges)
    tables = sum(12 * min(mr + 2, W) for mr in max_ranges)
    return "stream_sample", n * 9 + tables + S * 16, n * 30


def compact(n_records: Sequence[int], kept: Sequence[int]) -> Launch:
    """B2, the kept records' positions: each record's keep byte read, a
    4-byte position written for each kept record, a total a row; a scan
    step and a compare a record."""
    R, n = len(n_records), sum(n_records)
    return "compact", n + 4 * sum(kept) + 4 * R, 2 * n


def metrics_fused(valid: Sequence[int], ranges: Sequence[int]) -> Launch:
    """B3 over rows of ``valid`` stamps each: the stamps read, a length a
    row, each row's histogram over its own range of buckets and its two
    4-byte moments written."""
    S, n, buckets = len(valid), sum(valid), sum(ranges)
    return ("metrics_fused", n * 4 + S * 4 + buckets * 4 + S * 8,
            n * 3 + buckets * 4)


def trend_scan(rows: int, width: int) -> Launch:
    """B4: an inclusive prefix sum of each 4-byte count of the rows, read
    and written."""
    return "trend_scan", rows * width * 8, rows * width


def pair_stats(rows: int, points: int) -> Launch:
    """B5: the centred trends on their common grid read, the row sums and
    the Gram matrix written; a multiply-add a pair and point."""
    S, K = rows, points
    return ("pair_stats", S * K * 4 + S * 4 + S * S * 4,
            S * (S + 1) * K + S * K)


def job_launches(entry: str, datasets: Sequence[str],
                 max_ranges: Sequence[int], records: Dict[str, int],
                 seconds: Dict[str, int],
                 kept: Dict[Tuple[str, int], int]) -> List[Launch]:
    """The kernel work one job of a cell needs.

    ``records`` and ``seconds`` give each original's length and its span
    in whole seconds; ``kept`` each scenario's simulated records.
    ``Controller.run`` runs one scenario a call (B1, B2, B3 on the sim, B3
    on the original); ``Controller.run_many`` one batch of every scenario
    (B1, B2, B3 on the sims, B3 on the originals) and per range one S×S
    fidelity matrix (B4 over the originals' and sims' count rows, B5 on
    their trends at the range's length)."""
    scen = [(d, int(mr)) for d in datasets for mr in max_ranges]
    if entry == "run":
        out = []
        for d, mr in scen:
            out += [stream_sample([records[d]], [mr]),
                    compact([records[d]], [kept[(d, mr)]]),
                    metrics_fused([kept[(d, mr)]], [mr]),
                    metrics_fused([records[d]], [seconds[d]])]
        return out
    n = [records[d] for d, _ in scen]
    out = [stream_sample(n, [mr for _, mr in scen]),
           compact(n, [kept[sc] for sc in scen]),
           metrics_fused([kept[sc] for sc in scen], [mr for _, mr in scen]),
           metrics_fused([records[d] for d in datasets],
                         [seconds[d] for d in datasets])]
    for mr in max_ranges:
        width = max([seconds[d] for d in datasets] + [int(mr)])
        points = min([seconds[d] for d in datasets] + [int(mr)])
        out += [trend_scan(2 * len(datasets), width),
                pair_stats(2 * len(datasets), points)]
    return out


def share(launches: List[Launch], jobs: int, trace) -> Tuple[float, float]:
    """``(bound seconds, device seconds)``: the least time of the work
    ``jobs`` jobs need, and the time every kernel took in ``trace`` (a
    :class:`~stream_bench.trace.DeviceTrace`), whatever its name and
    however the work is split into launches; copies are no kernels."""
    return (jobs * sum(bound_s(b, ops) for _, b, ops in launches),
            trace.kernel_s())
