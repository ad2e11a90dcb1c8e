#!/usr/bin/env python3
"""Kernels B1 (``stream_sample``) and B2 (``compact``) of two checkouts of
the repository, timed on the same inputs in the same way, on one NVIDIA
card.

    python3 tools/time_sample_compact.py --other DIR [--reps 20]
        [--scale 1.0] [--seed 0] [--out FILE]

``DIR`` holds another checkout (an earlier commit unpacked with ``git
archive``). Four processes, in the order other, this, this, other, each
import one checkout's ``repro_torch``, build its two kernels from its
``csrc/`` and B1's inputs with its own ``ops`` from the same streams: the
``run`` shape (the userbehavior day at max_range 3600), the ``run_many``
shard (the paper's 3 x 6 grid, 18 rows) and one nine-day chunk (buckets
[1800, 2400) of nine userbehavior days at 3600 s a day, as
``ChunkedNSA.sample_inputs`` gives them). At each shape each process holds
B1's ``ss`` and ``keep`` and B2's ``idx`` and ``totals`` to the plain
versions bit for bit and times:

- ``ms``: ``chip_smoke._time_ms``, the device time between CUDA events
  after a 256 MiB read that leaves L2 cold and hides the wrapper's host
  time;
- ``ms_64mib``: the same after a 64 MiB read, the size the timing used
  before (it hides less of the host time);
- ``host_ms``: ``chip_smoke._enqueue_ms``, the wrapper's own host time per
  call, measured while the card is busy.

B2 runs on the keep mask of the plain version of B1. Prints one JSON
object (each process's rows, and per checkout the median of its two
processes) and writes it to ``--out`` when given. The bounds are
``chip_smoke.py``'s, for a checkout whose B1 takes
``stream_sample.SampleArgs`` (null for one whose B1 takes other
arguments). Needs a CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

SHAPES = ("run", "sweep", "chunk")


def build_inputs(scale: float, seed: int, workdir: Path) -> dict:
    """B1's arguments at each shape on the card, from the ``repro_torch``
    this process imported (an older checkout's B1 took six tensors)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.streamsim import ChunkedNSA, Controller
    from repro_torch.streamsim.nsa import _multiple

    streams, _, _ = cs._streams(scale, seed)

    def b1_in(ts, ranges):
        mults = [_multiple(len(t), float(t[-1] - t[0]), mr, "time")
                 for t, mr in zip(ts, ranges)]
        inputs = ops.stream_sample_inputs(ts, ranges, mults)
        if hasattr(ops, "stream_sample_args"):
            return ops.stream_sample_args(inputs, "cuda")
        return tuple(torch.from_numpy(x).cuda() for x in inputs)

    out = {
        "run": b1_in([streams[cs.MAIN_DATASET].t], [cs.MAIN_RANGE]),
        "sweep": b1_in([streams[d].t for d in cs.SWEEP_DATASETS
                        for _ in cs.SWEEP_RANGES],
                       [mr for _ in cs.SWEEP_DATASETS
                        for mr in cs.SWEEP_RANGES]),
    }
    days = cs.MULTIDAY_S // 86_400
    original = Controller(str(workdir / "store"), device="cpu") \
        ._prepare_multiday(cs.MAIN_DATASET, scale, seed, cs.MULTIDAY_S)
    cn = ChunkedNSA({cs.MAIN_DATASET: original},
                    [(cs.MAIN_DATASET, cs.MAIN_RANGE * days)], device="cuda")
    lo = cs.MULTIDAY_TIMED_CHUNK * cs.CHUNK_S
    out["chunk"], _ = cn.sample_inputs(lo, lo + cs.CHUNK_S)
    return out


def time_tree(tree: Path, scale: float, seed: int, reps: int) -> dict:
    """One process's rows: ``tree``'s kernels at every shape."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.compact import compact, compact_plain
    from repro_torch.kernels.stream_sample import (stream_sample,
                                                   stream_sample_plain)
    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise AssertionError(f"imported {repro_torch.__file__}, not {tree}")
    _build.build_all(["stream_sample", "compact"])
    rows = {}
    with tempfile.TemporaryDirectory(prefix="b1b2_") as tmp:
        inputs = build_inputs(scale, seed, Path(tmp))
    for shape in SHAPES:
        b1_in = inputs.pop(shape)
        ss_p, keep = stream_sample_plain(*b1_in)
        ss, keep_k = stream_sample(*b1_in)
        cs._exact(f"stream_sample/{shape}/ss", ss, ss_p)
        cs._exact(f"stream_sample/{shape}/keep", keep_k, keep)
        idx, tot = compact(keep)
        idx_p, tot_p = compact_plain(keep)
        cs._exact(f"compact/{shape}/idx", idx, idx_p)
        cs._exact(f"compact/{shape}/totals", tot, tot_p)
        S, N = ss.shape
        new_form = hasattr(b1_in, "base")
        W = (b1_in.starts if new_form else b1_in[1]).shape[1]
        b1 = dict(bound_ms=cs._b1_bound(b1_in, ss_p)[0] if new_form
                  else None)
        b2 = dict(bound_ms=cs._b2_bound(keep)[0])
        for row, fn in ((b1, lambda: stream_sample(*b1_in)),
                        (b2, lambda: compact(keep))):
            row["ms"] = cs._time_ms(fn, reps)
            row["ms_64mib"] = cs._time_ms(fn, reps, flush_bytes=64 << 20)
            row["host_ms"] = cs._enqueue_ms(fn, reps)
        rows[shape] = {"shape": f"S={S} N={N} W={W} kept={int(tot.sum())}",
                       "stream_sample": b1, "compact": b2}
        del b1_in, ss_p, keep, ss, keep_k, idx, tot, idx_p, tot_p
        torch.cuda.empty_cache()
    return rows


def medians(runs):
    """The element-wise median of the runs' nested rows (numbers; other
    values are taken from the first run)."""
    first = runs[0]
    if isinstance(first, dict):
        return {k: medians([r[k] for r in runs]) for k in first}
    if isinstance(first, (int, float)) and not isinstance(first, bool):
        return float(np.median(runs))
    return first


def run_workers(script: Path, trees: dict, inputs_file: Path, reps: int,
                extra=lambda which, i: ()) -> dict:
    """``script --worker TREE --inputs FILE --reps N`` and ``extra(which,
    i)`` (the tree's name, the process's index among its tree's) in four
    processes, in the order other, this, this, other; returns each tree's
    list of the JSON objects its processes printed last."""
    runs = {"other": [], "this": []}
    for which in ("other", "this", "this", "other"):
        proc = subprocess.run(
            [sys.executable, str(script), "--worker", str(trees[which]),
             "--inputs", str(inputs_file), "--reps", str(reps),
             *extra(which, len(runs[which]))],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"the {which} checkout's process failed "
                               f"(exit {proc.returncode})")
        runs[which].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def write_result(result: dict, out) -> None:
    text = json.dumps(result)
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(text + "\n")
    print(text)


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
    import torch
    if not torch.cuda.is_available():
        print("time_sample_compact: needs a CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(time_tree(args.worker, args.scale, args.seed,
                                   args.reps)))
        return 0
    if args.other is None or not (
            args.other / "src/repro_torch/csrc/compact.cu").is_file():
        ap.error("--other must name a checkout holding src/repro_torch")
    trees = {"other": args.other.resolve(), "this": ROOT}
    # each process builds its inputs: no file passes between them
    runs = run_workers(Path(__file__).resolve(), trees, Path(os.devnull),
                       args.reps, extra=lambda which, i: (
                           "--scale", str(args.scale),
                           "--seed", str(args.seed)))
    write_result({"card": cs._card_line(), "other": str(args.other),
                  "reps": args.reps, "runs": runs,
                  "median": {k: medians(v) for k, v in runs.items()}},
                 args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
