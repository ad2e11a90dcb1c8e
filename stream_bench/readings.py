"""The readings that the limits of a cell's checks are set from.

    python3 stream_bench/readings.py --workload ub-day.r3600 \\
        --seeds 101,102,103 --control-seeds 201,202,203 --seconds 4 \\
        --out readings_ub-day.r3600.json

For each of ``--seeds`` it makes a whole run of the cell on the card with
a short window (every job of it compared), and for each of
``--control-seeds`` it puts the control in the program's place: the plain
reference computed one precision lower than the configuration states
(``stream_bench/reference/simulate.py``, ``low=True``), at the cell's own
size, judged by the same comparison. It prints, and writes to ``--out``,
each seed's numbers, the lower reading (the largest over the program's
seeds) and the upper one (the smallest over the control's). The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from stream_bench import bench, judge

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    out = {"workload": args.workload, "program": {}, "control": {}}
    for seed in seeds:
        t0 = time.perf_counter()
        r = bench.run_cell(args.workload, seed, args.seconds, False)
        out["program"][seed] = {
            "correct": r["correct"], "jobs": r["attempted"],
            "failed": r["failed"], "seconds": time.perf_counter() - t0,
            "numbers": {k: c["value"] for k, c in r["checks"].items()}}
        print(json.dumps({"seed": seed, **out["program"][seed]}),
              file=sys.stderr, flush=True)
    for seed in control:
        t0 = time.perf_counter()
        cell = bench.Cell(args.workload, seed)
        try:
            cell.make_raw()
            exp = cell.expected()
            low = cell.expected(low=True)
            ok, checks = judge.judge(exp, [judge.output_of(low)],
                                     cell.config["limits"], cell.posd)
        finally:
            cell.close()
        out["control"][seed] = {
            "correct": ok, "seconds": time.perf_counter() - t0,
            "numbers": {k: c["value"] for k, c in checks.items()}}
        print(json.dumps({"control_seed": seed, **out["control"][seed]}),
              file=sys.stderr, flush=True)
    names = sorted({k for side in out.values() if isinstance(side, dict)
                    for r in side.values() for k in r["numbers"]})
    out["readings"] = {k: {
        "lower": max((r["numbers"][k] for r in out["program"].values()),
                     default=None),
        "upper": min((r["numbers"][k] for r in out["control"].values()),
                     default=None)} for k in names}
    text = json.dumps(out, indent=1, default=str)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
