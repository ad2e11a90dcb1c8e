#!/usr/bin/env python3
"""Kernels B3 (``stream_metrics``) and B6 (``stream_metrics_carry``) of two
checkouts of the repository, timed on the same inputs in the same way, on
one NVIDIA card.

    python3 tools/time_metrics.py --other DIR [--reps 20] [--scale 1.0]
        [--seed 0] [--out FILE]

``DIR`` holds another checkout (an earlier commit unpacked with ``git
archive``). This checkout builds the inputs once, on the card, through the
plain versions of B1 and B2 (``chip_smoke.py``'s shapes): B3 on the
original userbehavior day (1 x 10,631,168 stamps, 86,528 buckets), on the
run path's kept stamps (max_range 3600) and on the sweep's 18-row shard of
kept stamps; B6 on chunk 0 of the grid (its kept stamps, and all its
records) and on the day's [1800, 2400) s rebased by its first bucket, each
under a seeded random carry. Then four processes, in the order other,
this, this, other (``tools/time_sample_compact.py``'s scheme), each import
one checkout's ``repro_torch``, build its ``metrics_fused`` from its
``csrc/`` and, at each shape, hold the histogram to the plain version bit
for bit and the moments within 1e-5 relative, save its outputs, and time:

- ``ms``: ``chip_smoke._time_ms``, the device time between CUDA events
  after a 256 MiB read that leaves L2 cold and hides the wrapper's host
  time;
- ``host_ms``: ``chip_smoke._enqueue_ms``, the wrapper's own host time per
  call, measured while the card is busy.

The main process then holds this checkout's outputs to the other's: the
histograms bit for bit, and reports whether the moments are bit-equal and
their largest relative difference (each checkout's two processes must
agree the same way). Prints one JSON object (each process's
rows, per checkout the median of its two processes, and the comparison)
and writes it to ``--out`` when given. The bounds are ``chip_smoke.py``'s.
Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
from time_sample_compact import (medians, run_workers,  # noqa: E402
                                 write_result)

#: where the inputs are built and the kernels run (a CPU rehearsal of the
#: script's logic sets "cpu", which times the plain versions)
DEVICE = "cuda"
B3_SHAPES = ("original", "run_sim", "sweep_sims")
B6_SHAPES = ("grid_chunk0_kept", "grid_chunk0_records", "multiday_chunk")


def _b12_outputs(ts, ranges):
    """B1's and B2's outputs at one case, through their plain versions on
    the card: ``ss``, ``lengths``, ``kept`` and ``totals``, as
    ``chip_smoke.check_kernels`` keeps them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.compact import compact_plain
    from repro_torch.kernels.stream_sample import stream_sample_plain
    from repro_torch.streamsim.nsa import _multiple
    mults = [_multiple(len(t), float(t[-1] - t[0]), mr, "time")
             for t, mr in zip(ts, ranges)]
    b1_in = ops.stream_sample_args(
        ops.stream_sample_inputs(ts, ranges, mults), DEVICE)
    ss, keep = stream_sample_plain(*b1_in)
    idx, tot = compact_plain(keep)
    return dict(ss=ss, lengths=b1_in.lengths,
                kept=cs._kept_stamps(ss, idx, tot),
                totals=tot)


def build_inputs(scale: float, seed: int) -> dict:
    """The arguments of every timed call, as CPU tensors:
    ``{shape: (ss, lengths, buckets[, mcar, base])}``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.streamsim.metrics import _bucket_series

    streams, _, _ = cs._streams(scale, seed)
    main = _b12_outputs([streams[cs.MAIN_DATASET].t], [cs.MAIN_RANGE])
    sweep = _b12_outputs(
        [streams[d].t for d in cs.SWEEP_DATASETS for _ in cs.SWEEP_RANGES],
        [mr for _ in cs.SWEEP_DATASETS for mr in cs.SWEEP_RANGES])
    sim_buckets = -(-cs.MAIN_RANGE // ops.BUCKET_BLOCK) * ops.BUCKET_BLOCK
    b_orig, tr = _bucket_series(streams[cs.MAIN_DATASET], None, None)
    ssb, lens, buckets = ops.stream_metrics_inputs([b_orig], tr)
    out = {
        "original": (torch.from_numpy(ssb), torch.from_numpy(lens), buckets),
        "run_sim": (main["kept"], main["totals"], sim_buckets),
        "sweep_sims": (sweep["kept"], sweep["totals"], sim_buckets),
    }
    rng = np.random.default_rng(seed)
    for shape, (ss, lengths, base, b) in cs._b6_timing_cases(
            main, sweep).items():
        S = ss.shape[0]
        mcar = torch.from_numpy(np.stack(
            [rng.uniform(0, 5e5, S), rng.uniform(-1, 1, S),
             rng.uniform(0, 5e8, S), rng.uniform(-64, 64, S)],
            axis=1).astype(np.float32))
        out[shape] = (ss, lengths, b, mcar, base)
    return {k: tuple(x.cpu().contiguous() if hasattr(x, "cpu") else x
                     for x in v) for k, v in out.items()}


def _bound(shape: str, args) -> float:
    """``chip_smoke.py``'s bound of B3 (whole rows) or B6 (the counted
    prefix) at these inputs."""
    ss, lengths, buckets = args[:3]
    S, N = ss.shape
    if shape in B3_SHAPES:
        return cs._bound_ms(S * N * 4 + S * 4 + S * buckets * 4 + S * 8,
                            S * N * 3 + S * buckets * 4)[0]
    n_valid = int(lengths.sum())
    return cs._bound_ms(
        n_valid * 4 + S * 4 + S * 16 + S * buckets * 4 + S * 16,
        n_valid * 3 + S * buckets * 4)[0]


def time_tree(tree: Path, inputs_file: Path, reps: int, dump: Path) -> dict:
    """One process's rows: ``tree``'s B3 and B6 at every shape; their
    outputs saved to ``dump``."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.metrics_fused import (
        stream_metrics, stream_metrics_carry, stream_metrics_carry_plain,
        stream_metrics_plain)
    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise AssertionError(f"imported {repro_torch.__file__}, not {tree}")
    _build.build_all(["metrics_fused"])
    inputs = torch.load(inputs_file)
    rows, outputs = {}, {}
    for shape in (*B3_SHAPES, *B6_SHAPES):
        args = tuple(x.to(DEVICE) if hasattr(x, "to") else x
                     for x in inputs[shape])
        if shape in B3_SHAPES:
            def fn():
                return stream_metrics(*args)
            hist_p, mom_p = stream_metrics_plain(*args)
        else:
            ss, lengths, buckets, mcar, base = args

            def fn():
                return stream_metrics_carry(ss, lengths, buckets, mcar, base)
            hist_p, mom_p = stream_metrics_carry_plain(*args)
        hist, mom = fn()
        cs._exact(f"{shape}/hist", hist, hist_p)
        cols = slice(None) if shape in B3_SHAPES else slice(None, None, 2)
        cs._moments_err(f"{shape}/moments", mom[:, cols], mom_p[:, cols])
        outputs[shape] = (hist.cpu(), mom.cpu())
        S, N = args[0].shape
        rows[shape] = dict(
            shape=f"S={S} N={N} B={args[2]} counted={int(args[1].sum())}",
            bound_ms=_bound(shape, args), ms=cs._time_ms(fn, reps),
            host_ms=cs._enqueue_ms(fn, reps))
        del args, hist, mom, hist_p, mom_p
        torch.cuda.empty_cache()
    torch.save(outputs, dump)
    return rows


def compare(this: Path, other: Path) -> dict:
    """This checkout's outputs against the other's, at every shape."""
    import torch
    a, b = torch.load(this), torch.load(other)
    out = {}
    for shape in a:
        (ha, ma), (hb, mb) = a[shape], b[shape]
        cs._exact(f"{shape}: hist against the other checkout's", ha, hb)
        if ma.shape[1] == 4:                # B6: the running sums
            ma, mb = ma[:, ::2], mb[:, ::2]
        rel = ((ma.double() - mb.double()).abs() /
               mb.double().abs().clamp(min=1e-30)).max()
        out[shape] = {"hist_bit_equal": True,
                      "moments_bit_equal": bool(torch.equal(ma, mb)),
                      "max_moment_rel_diff": float(rel)}
        if not float(rel) <= cs.MOMENT_RTOL:
            raise AssertionError(f"{shape}: moments {float(rel)} from the "
                                 "other checkout's")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dump", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import json

    import torch
    if not torch.cuda.is_available():
        print("time_metrics: needs a CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(time_tree(args.worker, args.inputs, args.reps,
                                   args.dump)))
        return 0
    if args.other is None or not (
            args.other / "src/repro_torch/csrc/metrics_fused.cu").is_file():
        ap.error("--other must name a checkout holding src/repro_torch")
    trees = {"other": args.other.resolve(), "this": ROOT}
    with tempfile.TemporaryDirectory(prefix="b3b6_") as tmp:
        inputs_file = Path(tmp) / "inputs.pt"
        torch.save(build_inputs(args.scale, args.seed), inputs_file)
        torch.cuda.empty_cache()
        def dump(which, i):
            return Path(tmp) / f"{which}{i}.pt"
        runs = run_workers(Path(__file__).resolve(), trees, inputs_file,
                           args.reps,
                           lambda which, i: ("--dump", str(dump(which, i))))
        outputs = compare(dump("this", 0), dump("other", 0))
        for which in trees:                 # each tree's two runs agree
            compare(dump(which, 1), dump(which, 0))
    write_result({"card": cs._card_line(), "other": str(args.other),
                  "reps": args.reps, "runs": runs,
                  "median": {k: medians(v) for k, v in runs.items()},
                  "this_against_other": outputs}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
