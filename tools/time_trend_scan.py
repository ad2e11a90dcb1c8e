#!/usr/bin/env python3
"""Kernels B4 (``trend_scan``) and B7 (``trend_scan_carry``) of two
checkouts of the repository, timed on the same inputs in the same way, on
one NVIDIA card.

    python3 tools/time_trend_scan.py --other DIR [--reps 20]
        [--scale 1.0] [--seed 0] [--out FILE]

``DIR`` holds another checkout (an earlier commit unpacked with ``git
archive``). This checkout builds the inputs once: B4's at the fidelity
shape of the sweep's largest range (the three originals' and sims' count
rows, ``chip_smoke._fidelity_counts``) and on the week row (one row of
604,800 entries whose total ends just under 2^31), B7's at the nine-day
path's chunk (a 659-entry row: the trend window's tail and one 600 s
chunk of a day's counts, seeded with the total before them). Then four
processes, in the order other, this, this, other, each import one
checkout's ``repro_torch``, build ``trend_scan.cu`` from its ``csrc/``
and, at each shape, hold the kernel to its plain version bit for bit and
time it with ``chip_smoke._time_ms`` (CUDA events, cold L2). Prints one
JSON object (each process's rows, and per checkout the median of its two
processes) and writes it to ``--out`` when given. Needs a CUDA device;
fails without one.
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


def build_inputs(scale: float, seed: int) -> dict:
    """Each shape's arguments as CPU tensors: ``(q,)`` for B4, ``(q,
    init)`` for B7."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops
    from repro_torch.streamsim import per_second_counts

    streams, _, _ = cs._streams(scale, seed)
    q_np, _ = cs._fidelity_counts(streams, max(cs.SWEEP_RANGES))
    day = per_second_counts(streams[cs.MAIN_DATASET]).astype(np.int32)
    lo = 3 * cs.CHUNK_S
    ext = day[None, lo - cs.TREND_WINDOW + 1:lo + cs.CHUNK_S]
    t = torch.from_numpy
    return {
        "fidelity": (ops._pad_cols(t(q_np), ops.TILE),),
        "week": (ops._pad_cols(t(np.full((1, 604_800), 3550, np.int32)),
                               ops.TILE),),
        "multiday_ext": (t(np.ascontiguousarray(ext)), t(np.array(
            [day[:lo - cs.TREND_WINDOW + 1].sum()], np.int32))),
    }


def time_tree(tree: Path, inputs_file: Path, reps: int) -> dict:
    """One process's rows: ``tree``'s B4 and B7 at every shape."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.trend_scan import (trend_scan,
                                                trend_scan_carry,
                                                trend_scan_carry_plain,
                                                trend_scan_plain)
    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise AssertionError(f"imported {repro_torch.__file__}, not {tree}")
    _build.build_all(["trend_scan"])
    inputs = torch.load(inputs_file)
    rows = {}
    for shape, args in inputs.items():
        args = tuple(x.cuda() for x in args)
        if len(args) == 1:
            fn = (lambda: trend_scan(*args))
            cs._exact(f"trend_scan/{shape}", fn(), trend_scan_plain(*args))
            name = "trend_scan"
        else:
            fn = (lambda: trend_scan_carry(*args))
            for got, want in zip(fn(), trend_scan_carry_plain(*args)):
                cs._exact(f"trend_scan_carry/{shape}", got, want)
            name = "trend_scan_carry"
        S, N = args[0].shape
        rows[shape] = {"kernel": name, "shape": f"S={S} N={N}",
                       "ms": cs._time_ms(fn, reps),
                       "bound_ms": cs._bound_ms(S * N * 8, S * N)[0]}
    return rows


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
    args = ap.parse_args()
    import json

    import torch
    if not torch.cuda.is_available():
        print("time_trend_scan: needs a CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(time_tree(args.worker, args.inputs, args.reps)))
        return 0
    if args.other is None or not (
            args.other / "src/repro_torch/csrc/trend_scan.cu").is_file():
        ap.error("--other must name a checkout holding src/repro_torch")
    trees = {"other": args.other.resolve(), "this": ROOT}
    with tempfile.TemporaryDirectory(prefix="b4b7_") as tmp:
        inputs_file = Path(tmp) / "inputs.pt"
        torch.save(build_inputs(args.scale, args.seed), inputs_file)
        runs = run_workers(Path(__file__).resolve(), trees, inputs_file,
                           args.reps)
    write_result({"card": cs._card_line(), "other": str(args.other),
                  "reps": args.reps, "runs": runs,
                  "median": {k: medians(v) for k, v in runs.items()}},
                 args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
