"""What the benchmark loads: a run's set-up and one job on the CPU, in a
process of their own, load no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (compared whole: ``repro_torch`` is the
port), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

_JOB = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from stream_bench import bench, run
cell = bench.Cell("ub-day.r600", 2**31 + 9, "cpu", 0.002)
try:
    cell.set_up()
    job = cell.run_job(0)
finally:
    cell.close()
print(json.dumps({{"error": job.error, "reports": len(job.reports),
                  "forbidden": run.forbidden_modules(),
                  "port": "repro_torch" in sys.modules}}))
"""


def _python(code: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_job_loads_no_jax_and_no_jax_package():
    got = _python(_JOB.format(root=str(ROOT), src=str(ROOT / "src")))
    assert got["error"] is None and got["reports"] == 1
    assert got["port"]
    assert got["forbidden"] == []


def test_forbidden_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from stream_bench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.kernels",
                                  "jaxtyping", "flaxen.x", "numpy"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.streamsim", "jax",
                                  "jaxlib.xla", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in {"__future__", "dataclasses",
                                           "typing", "numpy"}, (path, n)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r});"
            "import stream_bench.reference.simulate, "
            "stream_bench.reference.generators, json;"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'torch'})))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
