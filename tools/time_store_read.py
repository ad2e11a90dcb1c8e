#!/usr/bin/env python3
"""Three ways of reading one stored original back, timed on the host.

    python3 tools/time_store_read.py [--dataset userbehavior] [--scale 1.0]
        [--seed 0] [--reps 5] [--dir DIR] [--out FILE]

The original (``make_stream`` then ``preprocess``, as ``Controller.prepare``
makes it) is written once with ``StreamStore.put`` under ``--dir`` (a new
temporary directory by default, removed at the end). Then, ``--reps`` times
and in a rotating order, each way reads the file and does what a job does
with it on the host:

- ``np_load``: ``np.load`` of every member, the store's earlier read;
- ``in_place``: ``StreamStore.get``: the time column in one read, the
  payload columns mapped;
- ``read_all``: every member in one read into an array of its own, nothing
  mapped (the in-place read's member offsets, ``readinto`` for each).

After each read: ``gather_3600`` and ``gather_600``, every column
fancy-indexed at sorted distinct rows, as many as NSA keeps at max_range
3600 and 600 of a full day (443,392 and 73,920 of 10,631,168, scaled to
the stream), seeded; and ``bucket``, ``np.floor(t - t[0])``. Each read's
columns are checked equal to ``np_load``'s. Before the reps, one traced
``StreamStore.get`` gives the counts of its span ``store.read`` (``bytes``,
``mapped``). Prints one JSON object (every rep's seconds, each way's
medians, the span's counts and the host) and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tracing  # noqa: E402
from repro_torch.streamsim import store as store_mod  # noqa: E402
from repro_torch.streamsim.datasets import make_stream  # noqa: E402
from repro_torch.streamsim.preprocess import preprocess  # noqa: E402

#: rows NSA keeps of the full userbehavior day, by max_range
KEPT_OF_A_DAY = {3600: 443_392, 600: 73_920}
DAY_ROWS = 10_631_168
KEY = "orig"


def np_load(path: Path) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def in_place(store: store_mod.StreamStore) -> dict:
    s = store.get(KEY)
    out = {"__t__": s.t}
    out.update({f"c:{k}": v for k, v in s.payload.items()})
    return out


def read_all(path: Path) -> dict:
    out = {}
    with open(path, "rb") as f:
        members = store_mod._members_in_place(f)
        if members is None:
            raise SystemExit(f"{path} cannot be read in place")
        for key, (offset, dtype, shape) in members.items():
            a = np.empty(shape, dtype)
            f.seek(offset)
            if f.readinto(a.reshape(-1).view(np.uint8)) != a.nbytes:
                raise SystemExit(f"{path}: short read of {key}")
            out[key] = a
    return out


def one(read, rows: dict) -> tuple:
    """Seconds of one read and of what a job does after it, and the
    columns read."""
    t0 = time.perf_counter()
    cols = read()
    t1 = time.perf_counter()
    out = {"load": t1 - t0}
    for mr, idx in rows.items():
        t2 = time.perf_counter()
        got = {k: v[idx] for k, v in cols.items()}
        out[f"gather_{mr}"] = time.perf_counter() - t2
        del got
    t3 = time.perf_counter()
    np.floor(cols["__t__"] - cols["__t__"][0])
    out["bucket"] = time.perf_counter() - t3
    out["total"] = sum(out.values())
    return out, cols


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="userbehavior")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    root = Path(args.dir or tempfile.mkdtemp(prefix="store_read_"))
    try:
        store = store_mod.StreamStore(root)
        t0 = time.perf_counter()
        stream = preprocess(make_stream(args.dataset, scale=args.scale,
                                        seed=args.seed))
        store.put(KEY, stream)
        made_s = time.perf_counter() - t0
        path = root / KEY / "columns.npz"
        n = len(stream)
        del stream
        rng = np.random.default_rng(args.seed)
        rows = {mr: np.sort(rng.choice(n, min(n, round(k * n / DAY_ROWS)),
                                       replace=False))
                for mr, k in KEPT_OF_A_DAY.items()}
        ways = {"np_load": lambda: np_load(path),
                "in_place": lambda: in_place(store),
                "read_all": lambda: read_all(path)}
        want = np_load(path)
        tracing.enable()
        store.get(KEY)
        tracing.enable(False)
        (read_counts,) = [r.counts for r in tracing.drain()
                          if r.name == "store.read"]
        reps = {w: [] for w in ways}
        for r in range(args.reps):
            names = list(ways)
            names = names[r % 3:] + names[:r % 3]
            for w in names:
                secs, cols = one(ways[w], rows)
                if list(cols) != list(want) or any(
                        cols[k].dtype != want[k].dtype
                        or cols[k].tobytes() != want[k].tobytes()
                        for k in want):
                    raise SystemExit(f"{w}: columns differ from np.load's")
                del cols
                reps[w].append(secs)
        medians = {w: {k: statistics.median(s[k] for s in v)
                       for k in v[0]} for w, v in reps.items()}
        result = {
            "dataset": args.dataset, "scale": args.scale, "seed": args.seed,
            "rows": n, "file_bytes": path.stat().st_size,
            "kept": {mr: len(i) for mr, i in rows.items()},
            "made_s": made_s, "host": platform.node(),
            "cpus": os.cpu_count(), "numpy": np.__version__,
            "store_read": read_counts, "medians": medians, "reps": reps,
        }
    finally:
        if args.dir is None:
            shutil.rmtree(root, ignore_errors=True)
    text = json.dumps(result, indent=1)
    print(json.dumps({"medians": medians, "rows": n,
                      "store_read": read_counts}, indent=1))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return result


if __name__ == "__main__":
    main()
