#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing catches it):

1. print the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build the three CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card — the
   main-path shapes of the userbehavior day (10.63 M records), a ragged
   4-row batch at max_range 60/600/1800/3600, a zero-span stream and a
   single-record stream — exact for integer outputs, 1e-5 relative for the
   moments; time kernel, plain version and the one-call library yardstick
   (CUDA events, median of several runs);
4. drive ``Controller(tmp, device="cuda").run("userbehavior", 3600, ...,
   scale=1.0, backend="torch")`` with every launch count set to 0 just
   before and read just after, and check it against the port's own
   ``backend="numpy"`` run on the same input;
5. print the ``kernels`` and ``report`` JSON lines and, last, the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
MOMENT_RTOL = 1e-5
#: launches each kernel must show on the main path: B1 and B2 once, B3 for
#: the kept stamps and again for the original stream's report statistics
MIN_LAUNCHES = {"stream_sample": 1, "compact": 1, "metrics_fused": 2}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs after one warm-up,
    each run between its own pair of CUDA events and started with a cold
    L2: a 64 MiB buffer, larger than the 50 MB L2, is read before each run,
    outside the timed span (read, not written, so no dirty lines are left
    to be written back inside the span)."""
    import torch
    fn()
    flush = torch.ones(16 << 20, dtype=torch.int32, device="cuda")
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


# ----------------------------------------------------------- phase 3: kernels
def _streams(scale: float, seed: int):
    """The real streams the checks run on: the three paper datasets at
    ``scale`` plus the degenerate shapes NSA must survive."""
    from repro_torch.streamsim import make_stream, preprocess
    out = {d: preprocess(make_stream(d, scale=scale, seed=seed))
           for d in ("userbehavior", "sogouq", "traffic")}
    t0 = float(out["userbehavior"].t[0])
    return out, np.full(5000, t0), np.array([t0])


def check_kernels(device: str, scale: float, seed: int,
                  timing_reps: int = 20, plain_reps: int = 3):
    """Phase 3: every kernel against its plain version at every case;
    returns the per-kernel timing rows of the main-path shapes."""
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
    }
    rows, errs = {}, {"stream_sample": 0.0, "compact": 0.0,
                      "metrics_fused": 0.0}
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
        # the kept-stamp matrix as nsa_sweep_device hands it to B3: the
        # first TILE-rounded max(totals) columns of the gathered stamps
        width = min(-(-max(int(tot.max()), 1) // ops.TILE) * ops.TILE,
                    ss.shape[1])
        kept = torch.gather(ss, 1, torch.clamp(
            idx[:, :width], max=ss.shape[1] - 1).long()).contiguous()
        hist, mom = stream_metrics(kept, tot, buckets)
        hist_p, mom_p = stream_metrics_plain(kept, tot, buckets)
        _exact(f"metrics_fused/{case}/hist", hist, hist_p)
        errs["metrics_fused"] = max(errs["metrics_fused"], _moments_err(
            f"metrics_fused/{case}", mom, mom_p))
        q = hist.double().cpu().numpy()
        _moments_err(f"metrics_fused/{case}/f64", mom,
                     torch.from_numpy(np.stack([q.sum(1), (q * q).sum(1)],
                                               axis=1)))
        if case != "main":
            continue
        S, N = b1_in[0].shape
        W = b1_in[1].shape[1]
        bound, by = _bound_ms(S * N * (4 + 4 + 1) + 3 * S * W * 4 + S * 16,
                              S * N * 30)
        rows["stream_sample"] = dict(
            ms=_time_ms(lambda: stream_sample(*b1_in), timing_reps),
            plain_ms=_time_ms(lambda: stream_sample_plain(*b1_in),
                              plain_reps),
            bound_ms=bound, bound_by=by, library_ms=None,
            shape=f"S={S} N={N} W={W}")
        rows["compact"] = dict(
            ms=_time_ms(lambda: compact(keep), timing_reps),
            plain_ms=_time_ms(lambda: compact_plain(keep), plain_reps),
            library_ms=_time_ms(
                lambda: torch.cumsum(keep, dim=1, dtype=torch.int32),
                timing_reps),
            shape=f"R={S} N={N} kept={int(tot.sum())}")
        rows["compact"]["bound_ms"], rows["compact"]["bound_by"] = \
            _bound_ms(S * N * (1 + 4) + S * 4, S * N * 4)
        Sk, Nk = kept.shape
        sim_row = kept[0, :int(tot[0])]
        sim = dict(
            ms=_time_ms(lambda: stream_metrics(kept, tot, buckets),
                        timing_reps),
            plain_ms=_time_ms(lambda: stream_metrics_plain(kept, tot,
                                                           buckets),
                              plain_reps),
            library_ms=_time_ms(lambda: torch.bincount(
                sim_row, minlength=buckets), timing_reps),
            bound_ms=_bound_ms(Sk * Nk * 4 + Sk * 4 + Sk * buckets * 4
                               + Sk * 8, Sk * Nk * 3 + Sk * buckets * 4)[0],
            shape=f"S={Sk} N={Nk} B={buckets} kept={int(tot.sum())}")

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
    S, N = ss_o.shape
    row = ss_o[0, :int(len_o[0])]
    rows["metrics_fused"] = dict(
        ms=_time_ms(lambda: stream_metrics(ss_o, len_o, buckets),
                    timing_reps),
        plain_ms=_time_ms(lambda: stream_metrics_plain(ss_o, len_o, buckets),
                          plain_reps),
        library_ms=_time_ms(lambda: torch.bincount(row, minlength=buckets),
                            timing_reps),
        shape=f"S={S} N={N} B={buckets} (original stream)", sim=sim)
    rows["metrics_fused"]["bound_ms"], rows["metrics_fused"]["bound_by"] = \
        _bound_ms(S * N * 4 + S * 4 + S * buckets * 4 + S * 8,
                  S * N * 3 + S * buckets * 4)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


# -------------------------------------------------------- phase 4: main path
def run_main_path(device: str, scale: float, seed: int, workdir: Path):
    """Phase 4: ``Controller.run`` through the kernels, with the launch
    counts zeroed just before and read just after, then the same run on
    the numpy backend as the reference."""
    from repro_torch.kernels.compact import compact
    from repro_torch.kernels.metrics_fused import stream_metrics
    from repro_torch.kernels.stream_sample import stream_sample
    from repro_torch.streamsim import Controller, StreamStore

    wrappers = {"stream_sample": stream_sample, "compact": compact,
                "metrics_fused": stream_metrics}
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
    a = StreamStore(workdir / "torch").get(key)
    b = StreamStore(workdir / "numpy").get(key)
    cols_a = {"t": a.t, "scale_stamp": a.scale_stamp, **a.payload}
    cols_b = {"t": b.t, "scale_stamp": b.scale_stamp, **b.payload}
    if cols_a.keys() != cols_b.keys() or any(
            cols_a[k].dtype != cols_b[k].dtype or
            cols_a[k].tobytes() != cols_b[k].tobytes() for k in cols_a):
        raise AssertionError("stored sims differ between torch and numpy")
    if (rep.original_rows, rep.simulated_rows) != \
            (ref.original_rows, ref.simulated_rows):
        raise AssertionError("row counts differ between torch and numpy")
    if not abs(rep.trend_corr - ref.trend_corr) <= 1e-3:
        raise AssertionError(f"trend_corr {rep.trend_corr} vs numpy "
                             f"{ref.trend_corr}")
    for which in ("original_volatility", "simulated_volatility"):
        va, vb = getattr(rep, which), getattr(ref, which)
        for f in ("average", "variance", "std_variance"):
            x, y = getattr(va, f), getattr(vb, f)
            if not (np.isfinite(x) and abs(x - y) <= 1e-3 * max(abs(y),
                                                                1e-12)):
                raise AssertionError(f"{which}.{f}: {x} vs numpy {y}")
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
    from repro_torch.kernels import _build

    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {len(_build.kernel_names())} kernels in {build_s:.1f} s")
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    rows = check_kernels("cuda", MAIN_SCALE, MAIN_SEED)
    check_s = time.perf_counter() - t0
    print(f"kernel checks passed in {check_s:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches, report = run_main_path("cuda", MAIN_SCALE, MAIN_SEED,
                                         Path(tmp))
    report.update(build_s=build_s, kernel_check_s=check_s)

    replaces = {
        "stream_sample": ("src/repro_torch/csrc/stream_sample.cu",
                          "src/repro/kernels/stream_sample.py:146"),
        "compact": ("src/repro_torch/csrc/compact.cu",
                    "src/repro/kernels/compact.py:139"),
        "metrics_fused": ("src/repro_torch/csrc/metrics_fused.cu",
                          "src/repro/kernels/metrics_fused.py:269"),
    }
    kernels = []
    for name, (source, tpu) in replaces.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": tpu, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"],
            **({"sim": r["sim"]} if "sim" in r else {})})
    print(json.dumps({"report": report}))
    print(f"card: {_card_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
