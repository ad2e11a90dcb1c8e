#!/usr/bin/env python3
"""Kernel B5 (``pair_stats``) of two checkouts of the repository, timed on
the same inputs in the same way, on one NVIDIA card.

    python3 tools/time_pair_stats.py --other DIR [--reps 20] [--scale 1.0]
        [--seed 0] [--phases] [--out FILE]

``DIR`` holds another checkout (an earlier commit unpacked with ``git
archive``). This checkout builds the inputs once: the sweep's fidelity
matrix at max_range 3600 (``chip_smoke.py``'s ``_centered_trends``: six
centered trends, K = 4096), the task bench's S = 2 shapes (K = 1024 and
4096), S = 37 at K = 86,528, and S = 64, 65 and 130 at K = 4096 (seeded
centered normals). Then four processes, in the order other, this, this,
other (``tools/time_sample_compact.py``'s scheme), each import one
checkout's ``repro_torch``, build its ``pair_stats`` from its ``csrc/``
and, at each shape, hold it to the plain version (``chip_smoke._pair_err``:
the Gram within 1e-4 of sqrt(G_aa G_bb)), save its outputs, and time:

- ``ms``: ``chip_smoke._time_ms``, the device time between CUDA events
  after a 256 MiB read that leaves L2 cold and hides the wrapper's host
  time;
- ``host_ms``: ``chip_smoke._enqueue_ms``, the wrapper's own host time per
  call, measured while the card is busy;
- ``library_ms``: ``x @ x.T`` in full f32 (TF32 off) on the same input.

The main process then holds the two checkouts' Gram matrices to each other
(within 1e-4 of sqrt(G_aa G_bb)) and reports whether they are bit-equal.
With ``--phases`` the main process then builds this checkout's
``pair_stats.cu`` again with ``-DPAIR_STATS_PHASES`` and launches it at
the fidelity, S = 2 (K = 1024), S = 37 and S = 64 shapes, each launch after
the same 256 MiB read: per phase (:data:`PHASES`), the microseconds from
the first block's start to each block's stamp (min, median, max over the
blocks that reach it; medians of three launches). Prints one JSON object
(each process's rows, per checkout the median of its two processes, the
comparison, the bounds, the phases) and writes it to ``--out`` when
given. The bounds are ``chip_smoke.py``'s. Needs a CUDA device; fails
without one.
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
#: shape -> (S, K) of the seeded inputs; "fidelity" is built from streams
SHAPES = {"fidelity": None, "S2_K1024": (2, 1024), "S2_K4096": (2, 4096),
          "S37": (37, 86_528), "S64": (64, 4096), "S65": (65, 4096),
          "S130": (130, 4096)}


def build_inputs(scale: float, seed: int) -> dict:
    """Every timed input, as CPU tensors: ``{shape: x (S, K) f32}``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ops

    streams, _, _ = cs._streams(scale, seed)
    q, lengths = cs._fidelity_counts(streams, max(cs.SWEEP_RANGES))
    q = ops._pad_cols(torch.from_numpy(q).to(DEVICE), ops.TILE)
    out = {"fidelity": cs._centered_trends(q, lengths, cs.TREND_WINDOW)}
    rng = np.random.default_rng(seed)
    for shape, sk in SHAPES.items():
        if sk is not None:
            x = rng.normal(0.0, 40.0, sk)
            out[shape] = torch.from_numpy(
                (x - x.mean(axis=1, keepdims=True)).astype(np.float32))
    return {k: v.cpu().contiguous() for k, v in out.items()}


def _bound(x) -> float:
    """``chip_smoke.py``'s bound of B5 on ``x``."""
    S, K = x.shape
    return cs._bound_ms(S * K * 4 + S * 4 + S * S * 4,
                        S * (S + 1) * K + S * K)[0]


def time_tree(tree: Path, inputs_file: Path, reps: int, dump: Path) -> dict:
    """One process's rows: ``tree``'s B5 at every shape; its outputs saved
    to ``dump``."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.trend_scan import pair_stats, pair_stats_plain
    if Path(repro_torch.__file__).resolve().parents[2] != tree.resolve():
        raise AssertionError(f"imported {repro_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["pair_stats"])
    inputs = torch.load(inputs_file)
    rows, outputs = {}, {}
    for shape, x_cpu in inputs.items():
        x = x_cpu.to(DEVICE)
        got = pair_stats(x)
        err, scaled = cs._pair_err(shape, got, pair_stats_plain(x),
                                   x.shape[1])
        outputs[shape] = (*(t.cpu() for t in got), x.shape[1])
        rows[shape] = dict(
            shape=f"S={x.shape[0]} K={x.shape[1]}", bound_ms=_bound(x),
            ms=cs._time_ms(lambda: pair_stats(x), reps),
            host_ms=cs._enqueue_ms(lambda: pair_stats(x), reps),
            library_ms=cs._time_ms(lambda: x @ x.T, reps),
            max_abs_err=err, max_scaled_err=scaled)
    torch.save(outputs, dump)
    return rows


def compare(this: Path, other: Path) -> dict:
    """This checkout's outputs against the other's, at every shape."""
    import torch
    a, b = torch.load(this), torch.load(other)
    out = {}
    for shape in a:
        got, want, k = a[shape][:2], b[shape][:2], a[shape][2]
        _, scaled = cs._pair_err(f"{shape}: against the other checkout",
                                 got, want, k)
        out[shape] = {"bit_equal": all(torch.equal(x, y) for x, y in
                                       zip(got, want)),
                      "max_scaled_diff": scaled}
    return out


#: the kernel's PHASE(i) stamps, in order
PHASES = ("start", "staged", "loop", "partial", "cluster_sync",
          "cluster_sum", "ticket", "written")


def phases(inputs_file: Path, shapes=("fidelity", "S2_K1024", "S37", "S64"),
           launches: int = 3) -> dict:
    """Per shape and phase, the min, median and max over the blocks of the
    microseconds from the first block's start; medians of ``launches``."""
    import ctypes
    import subprocess

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.trend_scan import pair_plan
    inputs = torch.load(inputs_file)
    with tempfile.TemporaryDirectory(prefix="b5_phases_") as tmp:
        lib_path = Path(tmp) / "libpair_stats_phases.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                        "-DPAIR_STATS_PHASES", "-o", str(lib_path),
                        str(_build.CSRC / "pair_stats.cu")], check=True,
                       capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(lib_path))
    P, i = ctypes.c_void_p, ctypes.c_int
    launch = lib.pair_stats_launch
    launch.argtypes = [P, i, i, i, i, i, P, P, P, P, P]
    tile, cluster, max_clusters, n_blocks = (
        lib.pair_stats_tile(), lib.pair_stats_cluster(),
        lib.pair_stats_max_clusters(), lib.pair_stats_phase_blocks())
    ws = _build.SplitWorkspace(torch.device(DEVICE))
    stream = P(torch.cuda.current_stream().cuda_stream)
    flush = torch.ones(64 << 20, dtype=torch.int32, device=DEVICE)
    out = {}
    for shape in shapes:
        x = inputs[shape].to(DEVICE)
        S, K = x.shape
        kc, n, pstride, tiles = pair_plan(S, K, max_clusters, tile, cluster)
        if n > cluster:
            ws.take(tiles * n // cluster * pstride, tiles)
        sums = torch.empty((S, 1), device=DEVICE)
        gram = torch.empty((S, S), device=DEVICE)

        def run():
            _build.check(launch(P(x.data_ptr()), S, K, kc, n, pstride,
                                P(ws.partials.data_ptr()),
                                P(ws.tickets.data_ptr()),
                                P(sums.data_ptr()), P(gram.data_ptr()),
                                stream), "pair_stats (phases)")
        run()
        per_launch = []
        for _ in range(launches):
            torch.cuda.synchronize()
            _build.check(lib.pair_stats_phase_clear(), "phase clear")
            flush.sum()
            run()
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * (n_blocks * 8))()
            _build.check(lib.pair_stats_phase_read(ctypes.cast(buf, P)),
                         "phase read")
            st = np.frombuffer(buf, np.uint64).reshape(n_blocks, 8)[
                :min(tiles * n, n_blocks)].astype(np.int64)
            t0 = st[:, 0].min()
            per_launch.append({
                name: {stat: float(f(st[st[:, k] > 0, k] - t0)) / 1e3
                       for stat, f in (("min", np.min), ("median", np.median),
                                       ("max", np.max))}
                for k, name in enumerate(PHASES) if (st[:, k] > 0).any()})
        out[shape] = dict(plan=dict(kc=kc, splits=n, tiles=tiles,
                                    clusters_per_tile=n // cluster),
                          us=medians(per_launch))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="another checkout of the repository")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", action="store_true",
                    help="also stamp this checkout's kernel phase by phase")
    ap.add_argument("--out", type=Path)
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--dump", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import json

    import torch
    if not torch.cuda.is_available():
        print("time_pair_stats: needs a CUDA device", file=sys.stderr)
        return 1
    if args.worker is not None:
        print(json.dumps(time_tree(args.worker, args.inputs, args.reps,
                                   args.dump)))
        return 0
    if args.other is None or not (
            args.other / "src/repro_torch/csrc/pair_stats.cu").is_file():
        ap.error("--other must name a checkout holding src/repro_torch")
    trees = {"other": args.other.resolve(), "this": ROOT}
    with tempfile.TemporaryDirectory(prefix="b5_") as tmp:
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
            for shape, c in compare(dump(which, 1), dump(which, 0)).items():
                if not c["bit_equal"]:
                    raise AssertionError(f"{which}/{shape}: two processes "
                                         "differ")
        stamped = phases(inputs_file) if args.phases else None
    write_result({"card": cs._card_line(), "other": str(args.other),
                  "reps": args.reps, "runs": runs,
                  "median": {k: medians(v) for k, v in runs.items()},
                  "this_against_other": outputs, "phases": stamped},
                 args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
