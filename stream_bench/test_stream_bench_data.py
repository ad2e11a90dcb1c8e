"""The harness is driven by data: in a copy of the benchmark, a new cell
(a traffic file and its entry) and a new metric (a reader file and its
entry) are found, run and read with no file of the copy's harness
edited."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_RUN = """
import json, sys
sys.path[:0] = [{copy!r}, {src!r}]
from stream_bench import bench
assert bench.ROOT == __import__("pathlib").Path({copy!r})
out = bench.run_cell("ub-day.r45", 3, 0.1, True, device="cpu", scale=0.002)
print(json.dumps({{"correct": out["correct"], "metrics": out["metrics"]}}))
"""


def _digests(d: Path) -> dict:
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(d.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_cell_and_metric_need_no_edit(tmp_path):
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy / "BENCHMARK.json")
    shutil.copytree(ROOT / "stream_bench", copy / "stream_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(copy / "stream_bench")

    (copy / "stream_bench" / "traffic" / "r45.json").write_text(
        json.dumps({"max_ranges": [45]}))
    (copy / "stream_bench" / "metrics" / "kept_per_job.py").write_text(
        "def read(run):\n"
        "    return float(sum(r.simulated_rows for j in run.jobs\n"
        "                     for r in j.reports)) / len(run.jobs)\n")
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "ub-day.r45", "config": "ub-day",
                              "traffic": "r45", "chips": 1,
                              "why": "a test cell"})
    spec["per_layer"].append({"name": "kept_per_job", "unit": "records",
                              "better": "higher",
                              "source": "program_counter", "layer": "NSA",
                              "moves": "job_s", "workloads": ["ub-day.r45"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _RUN.format(copy=str(copy),
                                           src=str(ROOT / "src"))],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(copy))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["metrics"]["kept_per_job"]["value"] > 0

    after = _digests(copy / "stream_bench")
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/r45.json",
                                        "metrics/kept_per_job.py"}
