"""One run of one cell of the stream simulator's benchmark.

    python3 stream_bench/run.py --workload ub-day.r3600 --seed 7 \\
        --seconds 51 --trace 0

Needs as many CUDA cards as the cell asks for (exits 1 and prints no
result without them). Prints the checks, each number beside its limit, as
its last lines on standard error, and one JSON object as the last line of
standard output: ``correct``, ``attempted`` and ``failed`` (jobs of the
window), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last. Exits 3, printing no result, if the process has loaded
JAX or the JAX package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names the port must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Loaded modules (``names``, by default ``sys.modules``) whose
    top-level name, compared whole, is forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _bytes_written() -> str:
    """Bytes this process wrote (``wchar``) and of them sent to storage
    (``write_bytes``), from ``/proc/self/io``."""
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().splitlines()
                      if ": " in line)
        return f"{io['wchar']} ({io['write_bytes']} to storage)"
    except (OSError, KeyError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from stream_bench import bench

    chips = int(bench.cell_of(bench.load_spec(ROOT), args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"stream_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    out = bench.run_cell(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t_start=T_START)
    out["device"]["count"] = chips
    bad = forbidden_modules()
    if bad:
        print(f"stream_bench: the run loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}; bytes written by this run: "
          f"{_bytes_written()}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
